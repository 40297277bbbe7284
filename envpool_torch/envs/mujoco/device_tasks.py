"""On-device MuJoCo gym tasks (``-Jax-v4``), the port's batched versions.

Counterpart of ``envpool_tpu/envs/mujoco/device_tasks.py``: the four
contact-free tasks ``ReacherJax-v4``, ``InvertedPendulumJax-v4``,
``InvertedDoublePendulumJax-v4`` and ``SwimmerJax-v4``, the contact
locomotion tasks ``HalfCheetahJax-v4``, ``HopperJax-v4``,
``Walker2dJax-v4``, ``AntJax-v4`` (free quaternion root), ``HumanoidJax-v4``
and ``HumanoidStandupJax-v4`` (23 dofs, all-pairs collision, the 376-dim
com-frame observation), and ``PusherJax-v4`` (cylinder contacts), which
run MuJoCo's contact pipeline (``device_collision.py``). Same names,
models, ``frame_skip``, configs, specs, state keys (``{"q", "v"}``,
Humanoid's with ``"mc"``), key use, observations, rewards, info fields
and termination as the JAX package, which follows the v4 generation of
``envpool/mujoco/gym/*.h``; written over ``[N, ...]`` tensors on the
engine of ``device_engine.py``, with the models loaded from the committed
data (``device_model.load_model``).

Known deviations from the host/gym implementation (documented contract):
- RNG streams are jax.random, not MT19937 — reset noise is identically
  *distributed*, not bit-identical (SURVEY §7 hard part #1);
- Reacher's goal rejection-sampling loop is replaced by an exact uniform
  polar draw on the same open disk (identical distribution, no loop);
- InvertedDoublePendulum's ``qfrc_constraint`` obs slice is computed at
  the post-step state; gym reports the value MuJoCo cached from the last
  substep's pre-integration forward pass. Both are exactly zero whenever
  the cart's rail limit is inactive, i.e. in the entire healthy regime.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from envpool_torch.core import graph, prng
from envpool_torch.core.env import FuncEnv
from envpool_torch.core.spec import ArraySpec

from . import device_engine as de
from .device_model import DeviceModel, load_model

_INF = float(np.finfo(np.float32).max)


def _qpos0(mdl: DeviceModel, keys: torch.Tensor) -> torch.Tensor:
  """qpos0 in float32 on the keys' device."""
  return de.consts_on(mdl, torch.float32, keys.device)["init_qpos"]


class DeviceMujocoEnv(FuncEnv):
  """Shared scaffolding: state = {q, v}; step = engine x frame_skip."""

  xml_file: str = ""
  frame_skip: int = 2

  @classmethod
  def mdl(cls) -> DeviceModel:
    return load_model(cls.xml_file)

  @classmethod
  def _physics(cls, state, action) -> Tuple[torch.Tensor, torch.Tensor]:
    return de.step_smooth(cls.mdl(), state["q"], state["v"], action,
                          nstep=cls.frame_skip)


class ReacherJaxEnv(DeviceMujocoEnv):
  """Reacher-v4 on-device (``envpool/mujoco/gym/reacher.h`` semantics)."""

  name = "ReacherJax"
  xml_file = "reacher.xml"
  frame_skip = 2

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {
      "reward_threshold": -3.75,
      "reset_qpos_scale": 0.1, "reset_qvel_scale": 0.005,
      "reset_goal_scale": 0.2,
    }

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {
      "obs": ArraySpec(np.float32, (11,), -_INF, _INF),
      "info:reward_dist": ArraySpec(np.float32, (-1,)),
      "info:reward_ctrl": ArraySpec(np.float32, (-1,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float32, (-1, 2), -1.0, 1.0)}

  @classmethod
  def _vec(cls, q):
    """fingertip - target, from one kinematics pass."""
    mdl = cls.mdl()
    xpos = de.fk(mdl, q)[0]
    return xpos[mdl.body_name2id["fingertip"]] - xpos[mdl.body_name2id["target"]]

  @classmethod
  def _obs(cls, state):
    q, v = state["q"], state["v"]
    theta = q[:, :2]
    return torch.cat(
      [torch.cos(theta), torch.sin(theta), q[:, 2:], v[:, :2], cls._vec(q)], 1
    )

  @classmethod
  def reset(cls, cfg: Any, state: Any, keys: torch.Tensor):
    del state
    mdl = cls.mdl()
    kq, kg, kr, kv = prng.split(keys, 4).unbind(-2)
    qs = float(cfg.reset_qpos_scale)
    gs = float(cfg.reset_goal_scale)
    q = _qpos0(mdl, keys) + prng.uniform(kq, (mdl.nq,), -qs, qs)
    # exact uniform draw on the open goal disk (same distribution as gym's
    # rejection loop, loop-free)
    r = gs * torch.sqrt(prng.uniform(kg, (), 0.0, 1.0))
    ang = prng.uniform(kr, (), 0.0, 2 * math.pi)
    q = torch.cat([q[:, :-2], (r * torch.cos(ang))[:, None],
                   (r * torch.sin(ang))[:, None]], 1)
    vs = float(cfg.reset_qvel_scale)
    v = prng.uniform(kv, (mdl.nv,), -vs, vs)
    v = torch.cat([v[:, :-2], torch.zeros_like(v[:, -2:])], 1)
    state = {"q": q, "v": v}
    zero = torch.zeros_like(r)
    return state, cls._obs(state), {"reward_dist": zero, "reward_ctrl": zero}

  @classmethod
  def step(cls, cfg: Any, state: Any, action: Any, keys: torch.Tensor):
    del keys
    action = action.to(torch.float32)
    vec = cls._vec(state["q"])
    reward_dist = -torch.sqrt((vec * vec).sum(-1))
    reward_ctrl = -(action * action).sum(-1)
    q1, v1 = cls._physics(state, action)
    state = {"q": q1, "v": v1}
    reward = reward_dist + reward_ctrl
    return state, cls._obs(state), reward, torch.zeros_like(reward, dtype=torch.bool), {
      "reward_dist": reward_dist, "reward_ctrl": reward_ctrl
    }


class InvertedPendulumJaxEnv(DeviceMujocoEnv):
  """InvertedPendulum-v4 on-device
  (``envpool/mujoco/gym/inverted_pendulum.h`` semantics)."""

  name = "InvertedPendulumJax"
  xml_file = "inverted_pendulum.xml"
  frame_skip = 2

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {
      "reward_threshold": 950.0, "healthy_reward": 1.0,
      "healthy_z_min": -0.2, "healthy_z_max": 0.2,
      "reset_noise_scale": 0.01,
    }

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"obs": ArraySpec(np.float32, (4,), -_INF, _INF)}

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float32, (-1, 1), -3.0, 3.0)}

  @classmethod
  def reset(cls, cfg: Any, state: Any, keys: torch.Tensor):
    del state
    mdl = cls.mdl()
    kq, kv = prng.split(keys).unbind(-2)
    s = float(cfg.reset_noise_scale)
    q = _qpos0(mdl, keys) + prng.uniform(kq, (mdl.nq,), -s, s)
    v = prng.uniform(kv, (mdl.nv,), -s, s)
    return {"q": q, "v": v}, torch.cat([q, v], 1), {}

  @classmethod
  def step(cls, cfg: Any, state: Any, action: Any, keys: torch.Tensor):
    del keys
    q1, v1 = cls._physics(state, action.to(torch.float32))
    obs = torch.cat([q1, v1], 1)
    term = ~torch.isfinite(obs).all(1) | (
      torch.abs(obs[:, 1]) > float(cfg.healthy_z_max)
    )
    reward = torch.full_like(q1[:, 0], float(cfg.healthy_reward))
    return {"q": q1, "v": v1}, obs, reward, term, {}


class InvertedDoublePendulumJaxEnv(DeviceMujocoEnv):
  """InvertedDoublePendulum-v4 on-device
  (``envpool/mujoco/gym/inverted_double_pendulum.h`` semantics)."""

  name = "InvertedDoublePendulumJax"
  xml_file = "inverted_double_pendulum.xml"
  frame_skip = 5

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {
      "reward_threshold": 9100.0, "healthy_reward": 10.0,
      "observation_min": -10.0, "observation_max": 10.0,
      "reset_noise_scale": 0.1,
    }

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"obs": ArraySpec(np.float32, (11,), -_INF, _INF)}

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float32, (-1, 1), -1.0, 1.0)}

  @classmethod
  def _obs(cls, state):
    mdl = cls.mdl()
    q, v = state["q"], state["v"]
    # qfrc_constraint at the current state (see the module docstring), with
    # zero tau, an unfloored solve and the full inverse, as the JAX package
    tau = torch.zeros_like(v)
    M, qfrc_smooth, _ = de._qacc_smooth_parts(mdl, q, v, tau)
    qacc_sm = de._solve_psd(M, qfrc_smooth)
    qfrc_con = de.limit_constraint_force(mdl, q, v, de._minv(mdl, M), qacc_sm)
    return torch.cat([
      q[:, :1], torch.sin(q[:, 1:]), torch.cos(q[:, 1:]),
      torch.clamp(v, -10.0, 10.0), torch.clamp(qfrc_con, -10.0, 10.0),
    ], 1)

  @classmethod
  def reset(cls, cfg: Any, state: Any, keys: torch.Tensor):
    del state
    mdl = cls.mdl()
    kq, kv = prng.split(keys).unbind(-2)
    s = float(cfg.reset_noise_scale)
    q = _qpos0(mdl, keys) + prng.uniform(kq, (mdl.nq,), -s, s)
    v = prng.normal(kv, (mdl.nv,)) * s
    state = {"q": q, "v": v}
    return state, cls._obs(state), {}

  @classmethod
  def step(cls, cfg: Any, state: Any, action: Any, keys: torch.Tensor):
    del keys
    mdl = cls.mdl()
    q1, v1 = cls._physics(state, action.to(torch.float32))
    state = {"q": q1, "v": v1}
    tip = de.site_xpos(mdl, q1, "tip")
    x, y = tip[:, 0], tip[:, 2]
    dist_penalty = 0.01 * x * x + (y - 2.0) ** 2
    v1_, v2_ = v1[:, 1], v1[:, 2]
    vel_penalty = 1e-3 * v1_ * v1_ + 5e-3 * v2_ * v2_
    reward = float(cfg.healthy_reward) - dist_penalty - vel_penalty
    return state, cls._obs(state), reward, y <= 1.0, {}


class SwimmerJaxEnv(DeviceMujocoEnv):
  """Swimmer-v4 on-device (``envpool/mujoco/gym/swimmer.h:33-160``): the
  fluid forces (density 4000, viscosity 0.1) are the dynamics, RK4, a
  3-joint torso (two slides and a hinge), no contacts."""

  name = "SwimmerJax"
  xml_file = "swimmer.xml"
  frame_skip = 4

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {
      "reward_threshold": 360.0,
      "forward_reward_weight": 1.0,
      "ctrl_cost_weight": 1e-4,
      "reset_noise_scale": 0.1,
    }

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {
      "obs": ArraySpec(np.float32, (8,), -_INF, _INF),
      "info:reward_fwd": ArraySpec(np.float32, (-1,)),
      "info:reward_ctrl": ArraySpec(np.float32, (-1,)),
      "info:x_position": ArraySpec(np.float32, (-1,)),
      "info:y_position": ArraySpec(np.float32, (-1,)),
      "info:distance_from_origin": ArraySpec(np.float32, (-1,)),
      "info:x_velocity": ArraySpec(np.float32, (-1,)),
      "info:y_velocity": ArraySpec(np.float32, (-1,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float32, (-1, 2), -1.0, 1.0)}

  @staticmethod
  def _obs(state):
    return torch.cat([state["q"][:, 2:], state["v"]], 1)

  @staticmethod
  def _info(q, reward_fwd, reward_ctrl, xv, yv):
    return {
      "reward_fwd": reward_fwd, "reward_ctrl": reward_ctrl,
      "x_position": q[:, 0], "y_position": q[:, 1],
      "distance_from_origin": torch.sqrt(q[:, 0] ** 2 + q[:, 1] ** 2),
      "x_velocity": xv, "y_velocity": yv,
    }

  @classmethod
  def reset(cls, cfg: Any, state: Any, keys: torch.Tensor):
    del state
    mdl = cls.mdl()
    kq, kv = prng.split(keys).unbind(-2)
    s = float(cfg.reset_noise_scale)
    q = _qpos0(mdl, keys) + prng.uniform(kq, (mdl.nq,), -s, s)
    v = prng.uniform(kv, (mdl.nv,), -s, s)
    state = {"q": q, "v": v}
    zero = torch.zeros_like(q[:, 0])
    return state, cls._obs(state), cls._info(q, zero, zero, zero, zero)

  @classmethod
  def step(cls, cfg: Any, state: Any, action: Any, keys: torch.Tensor):
    del keys
    mdl = cls.mdl()
    action = action.to(torch.float32)
    x0, y0 = state["q"][:, 0], state["q"][:, 1]
    q1, v1 = cls._physics(state, action)
    inv_dt = prng.inv32(cls.frame_skip * mdl.timestep)
    xv = (q1[:, 0] - x0) * inv_dt
    yv = (q1[:, 1] - y0) * inv_dt
    reward_fwd = float(cfg.forward_reward_weight) * xv
    ctrl_cost = float(cfg.ctrl_cost_weight) * (action * action).sum(-1)
    reward = reward_fwd - ctrl_cost
    state = {"q": q1, "v": v1}
    return state, cls._obs(state), reward, torch.zeros_like(reward, dtype=torch.bool), \
      cls._info(q1, reward_fwd, -ctrl_cost, xv, yv)


class HalfCheetahJaxEnv(DeviceMujocoEnv):
  """HalfCheetah-v4 on-device (``envpool/mujoco/gym/half_cheetah.h``).

  First contact-rich task through the device engine: 8 capsule-vs-plane
  candidate contacts with pyramidal friction, solved by the on-device
  Newton iteration (device_collision.py) at every Euler substep.
  """

  name = "HalfCheetahJax"
  xml_file = "half_cheetah.xml"
  frame_skip = 5

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {
      "reward_threshold": 4800.0,
      "forward_reward_weight": 1.0,
      "ctrl_cost_weight": 0.1,
      "reset_noise_scale": 0.1,
    }

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {
      "obs": ArraySpec(np.float32, (17,), -_INF, _INF),
      "info:reward_run": ArraySpec(np.float32, (-1,)),
      "info:reward_ctrl": ArraySpec(np.float32, (-1,)),
      "info:x_position": ArraySpec(np.float32, (-1,)),
      "info:x_velocity": ArraySpec(np.float32, (-1,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float32, (-1, 6), -1.0, 1.0)}

  @staticmethod
  def _obs(state):
    return torch.cat([state["q"][:, 1:], state["v"]], 1)

  @classmethod
  def reset(cls, cfg: Any, state: Any, keys: torch.Tensor):
    del state
    mdl = cls.mdl()
    kq, kv = prng.split(keys).unbind(-2)
    s = float(cfg.reset_noise_scale)
    q = _qpos0(mdl, keys) + prng.uniform(kq, (mdl.nq,), -s, s)
    # gym's HalfCheetah uses normal velocity noise (uniform positions)
    v = s * prng.normal(kv, (mdl.nv,))
    state = {"q": q, "v": v}
    zero = torch.zeros_like(q[:, 0])
    return state, cls._obs(state), {
      "reward_run": zero, "reward_ctrl": zero,
      "x_position": q[:, 0], "x_velocity": zero,
    }

  @classmethod
  def step(cls, cfg: Any, state: Any, action: Any, keys: torch.Tensor):
    del keys
    mdl = cls.mdl()
    action = action.to(torch.float32)
    x0 = state["q"][:, 0]
    q1, v1 = cls._physics(state, action)
    state = {"q": q1, "v": v1}
    xv = (q1[:, 0] - x0) * prng.inv32(cls.frame_skip * mdl.timestep)
    reward_run = float(cfg.forward_reward_weight) * xv
    ctrl_cost = float(cfg.ctrl_cost_weight) * (action * action).sum(-1)
    reward = reward_run - ctrl_cost
    return state, cls._obs(state), reward, torch.zeros_like(reward, dtype=torch.bool), {
      "reward_run": reward_run, "reward_ctrl": -ctrl_cost,
      "x_position": q1[:, 0], "x_velocity": xv,
    }


def _healthy_reward(cfg: Any, healthy: torch.Tensor):
  """(survive reward, terminated) per the terminate_when_unhealthy flag."""
  if bool(cfg.terminate_when_unhealthy):
    return torch.full(healthy.shape, float(cfg.healthy_reward),
                      device=healthy.device), ~healthy
  return (torch.where(healthy, float(cfg.healthy_reward), 0.0).to(torch.float32),
          torch.zeros_like(healthy))


class HopperJaxEnv(DeviceMujocoEnv):
  """Hopper-v4 on-device (``envpool/mujoco/gym/hopper.h``).

  RK4-integrated with contacts resolved at every stage (mj_RungeKutta
  evaluates the full constrained forward dynamics four times per
  substep); healthy-state termination per the v4 generation.
  """

  name = "HopperJax"
  xml_file = "hopper.xml"
  frame_skip = 4

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {
      "reward_threshold": 6000.0,
      "terminate_when_unhealthy": True,
      "forward_reward_weight": 1.0,
      "ctrl_cost_weight": 1e-3,
      "healthy_reward": 1.0,
      "velocity_min": -10.0, "velocity_max": 10.0,
      "healthy_state_min": -100.0, "healthy_state_max": 100.0,
      "healthy_angle_min": -0.2, "healthy_angle_max": 0.2,
      "healthy_z_min": 0.7,
      "reset_noise_scale": 5e-3,
    }

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {
      "obs": ArraySpec(np.float32, (11,), -_INF, _INF),
      "info:x_position": ArraySpec(np.float32, (-1,)),
      "info:x_velocity": ArraySpec(np.float32, (-1,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float32, (-1, 3), -1.0, 1.0)}

  @classmethod
  def _obs_of(cls, cfg, state):
    return torch.cat([
      state["q"][:, 1:],
      torch.clamp(state["v"], float(cfg.velocity_min), float(cfg.velocity_max)),
    ], 1)

  @classmethod
  def _healthy(cls, cfg, state):
    q, v = state["q"], state["v"]
    z, angle = q[:, 1], q[:, 2]
    lo, hi = float(cfg.healthy_state_min), float(cfg.healthy_state_max)
    st = torch.cat([q[:, 2:], v], 1)
    return (
      (z > float(cfg.healthy_z_min))
      & (angle > float(cfg.healthy_angle_min))
      & (angle < float(cfg.healthy_angle_max))
      & ((st > lo) & (st < hi)).all(1)
    )

  @classmethod
  def reset(cls, cfg: Any, state: Any, keys: torch.Tensor):
    del state
    mdl = cls.mdl()
    kq, kv = prng.split(keys).unbind(-2)
    s = float(cfg.reset_noise_scale)
    q = _qpos0(mdl, keys) + prng.uniform(kq, (mdl.nq,), -s, s)
    v = prng.uniform(kv, (mdl.nv,), -s, s)
    state = {"q": q, "v": v}
    return state, cls._obs_of(cfg, state), {
      "x_position": q[:, 0], "x_velocity": torch.zeros_like(q[:, 0]),
    }

  @classmethod
  def step(cls, cfg: Any, state: Any, action: Any, keys: torch.Tensor):
    del keys
    mdl = cls.mdl()
    action = action.to(torch.float32)
    x0 = state["q"][:, 0]
    q1, v1 = cls._physics(state, action)
    state = {"q": q1, "v": v1}
    xv = (q1[:, 0] - x0) * prng.inv32(cls.frame_skip * mdl.timestep)
    ctrl_cost = float(cfg.ctrl_cost_weight) * (action * action).sum(-1)
    survive, term = _healthy_reward(cfg, cls._healthy(cfg, state))
    reward = float(cfg.forward_reward_weight) * xv + survive - ctrl_cost
    return state, cls._obs_of(cfg, state), reward, term, {
      "x_position": q1[:, 0], "x_velocity": xv,
    }


class Walker2dJaxEnv(HopperJaxEnv):
  """Walker2d-v4 on-device (``envpool/mujoco/gym/walker2d.h``)."""

  name = "Walker2dJax"
  xml_file = "walker2d.xml"
  frame_skip = 4

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {
      "terminate_when_unhealthy": True,
      "forward_reward_weight": 1.0,
      "ctrl_cost_weight": 1e-3,
      "healthy_reward": 1.0,
      "velocity_min": -10.0, "velocity_max": 10.0,
      "healthy_z_min": 0.8, "healthy_z_max": 2.0,
      "healthy_angle_min": -1.0, "healthy_angle_max": 1.0,
      "reset_noise_scale": 5e-3,
    }

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {
      "obs": ArraySpec(np.float32, (17,), -_INF, _INF),
      "info:x_position": ArraySpec(np.float32, (-1,)),
      "info:x_velocity": ArraySpec(np.float32, (-1,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float32, (-1, 6), -1.0, 1.0)}

  @classmethod
  def _healthy(cls, cfg, state):
    z, angle = state["q"][:, 1], state["q"][:, 2]
    return (
      (z >= float(cfg.healthy_z_min))
      & (z <= float(cfg.healthy_z_max))
      & (angle >= float(cfg.healthy_angle_min))
      & (angle <= float(cfg.healthy_angle_max))
    )


def _planar_info(x, y, xv, yv) -> Dict[str, torch.Tensor]:
  return {
    "x_position": x, "y_position": y,
    "distance_from_origin": torch.sqrt(x ** 2 + y ** 2),
    "x_velocity": xv, "y_velocity": yv,
  }


class AntJaxEnv(DeviceMujocoEnv):
  """Ant-v4 on-device (``envpool/mujoco/gym/ant.h:30-226``).

  First free-joint (quaternion root) task through the device engine:
  RK4 over 3D rigid-body dynamics with 25 candidate plane contacts
  (8 leg capsules x 2 endpoints + torso sphere + 8 ankle capsules x 2)
  resolved by the on-device Newton solve each stage. The gym v4 default
  ``use_contact_forces=False`` observation (27-dim) is implemented;
  cfrc_ext observations are not (host tier covers that variant).
  """

  name = "AntJax"
  xml_file = "ant.xml"
  frame_skip = 5

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {
      "reward_threshold": 6000.0,
      "terminate_when_unhealthy": True,
      "forward_reward_weight": 1.0,
      "ctrl_cost_weight": 0.5,
      "healthy_reward": 1.0,
      "healthy_z_min": 0.2, "healthy_z_max": 1.0,
      "reset_noise_scale": 0.1,
    }

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {
      "obs": ArraySpec(np.float32, (27,), -_INF, _INF),
      "info:reward_forward": ArraySpec(np.float32, (-1,)),
      "info:reward_ctrl": ArraySpec(np.float32, (-1,)),
      "info:reward_survive": ArraySpec(np.float32, (-1,)),
      "info:x_position": ArraySpec(np.float32, (-1,)),
      "info:y_position": ArraySpec(np.float32, (-1,)),
      "info:distance_from_origin": ArraySpec(np.float32, (-1,)),
      "info:x_velocity": ArraySpec(np.float32, (-1,)),
      "info:y_velocity": ArraySpec(np.float32, (-1,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float32, (-1, 8), -1.0, 1.0)}

  @staticmethod
  def _obs(state):
    return torch.cat([state["q"][:, 2:], state["v"]], 1)

  @classmethod
  def _healthy(cls, cfg, state):
    z = state["q"][:, 2]
    finite = torch.isfinite(state["q"]).all(1) & torch.isfinite(state["v"]).all(1)
    return (
      finite
      & (z >= float(cfg.healthy_z_min))
      & (z <= float(cfg.healthy_z_max))
    )

  @classmethod
  def reset(cls, cfg: Any, state: Any, keys: torch.Tensor):
    del state
    mdl = cls.mdl()
    kq, kv = prng.split(keys).unbind(-2)
    s = float(cfg.reset_noise_scale)
    q = _qpos0(mdl, keys) + prng.uniform(kq, (mdl.nq,), -s, s)
    v = s * prng.normal(kv, (mdl.nv,))
    state = {"q": q, "v": v}
    zero = torch.zeros_like(q[:, 0])
    return state, cls._obs(state), {
      "reward_forward": zero, "reward_ctrl": zero, "reward_survive": zero,
      **_planar_info(q[:, 0], q[:, 1], zero, zero),
    }

  @classmethod
  def step(cls, cfg: Any, state: Any, action: Any, keys: torch.Tensor):
    del keys
    mdl = cls.mdl()
    action = action.to(torch.float32)
    x0, y0 = state["q"][:, 0], state["q"][:, 1]
    q1, v1 = cls._physics(state, action)
    state = {"q": q1, "v": v1}
    inv_dt = prng.inv32(cls.frame_skip * mdl.timestep)
    xv = (q1[:, 0] - x0) * inv_dt
    yv = (q1[:, 1] - y0) * inv_dt
    reward_forward = float(cfg.forward_reward_weight) * xv
    ctrl_cost = float(cfg.ctrl_cost_weight) * (action * action).sum(-1)
    survive, term = _healthy_reward(cfg, cls._healthy(cfg, state))
    reward = reward_forward + survive - ctrl_cost
    return state, cls._obs(state), reward, term, {
      "reward_forward": reward_forward, "reward_ctrl": -ctrl_cost,
      "reward_survive": survive,
      **_planar_info(q1[:, 0], q1[:, 1], xv, yv),
    }


class HumanoidJaxEnv(DeviceMujocoEnv):
  """Humanoid-v4 on-device (``envpool/mujoco/gym/humanoid.h``).

  The heaviest device task: 23 dofs, 140 candidate contact points
  (all-pairs filtering: frictionless body-body + pyramidal plane
  contacts), and the full 376-dim v4 observation — cinert/cvel are the
  com-frame quantities of ``de.com_quantities`` and cfrc_ext comes from
  the constraint solver's contact forces. Matching gymnasium exactly,
  the derived observation parts and the mass-center reward use the
  LAST FORWARD state (RK4 stage 4 of the final substep) that mjData
  retains after ``mj_step`` — not the integrated qpos (see
  ``step_smooth(want_aux=True)``); qpos/qvel in the observation are the
  fresh post-step values, as in gym.
  """

  name = "HumanoidJax"
  xml_file = "humanoid.xml"
  frame_skip = 5

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {
      "forward_reward_weight": 1.25,
      "terminate_when_unhealthy": True,
      "ctrl_cost_weight": 0.1,
      "healthy_reward": 5.0,
      "healthy_z_min": 1.0, "healthy_z_max": 2.0,
      "reset_noise_scale": 1e-2,
    }

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {
      "obs": ArraySpec(np.float32, (376,), -_INF, _INF),
      "info:reward_linvel": ArraySpec(np.float32, (-1,)),
      "info:reward_quadctrl": ArraySpec(np.float32, (-1,)),
      "info:reward_alive": ArraySpec(np.float32, (-1,)),
      "info:x_position": ArraySpec(np.float32, (-1,)),
      "info:y_position": ArraySpec(np.float32, (-1,)),
      "info:distance_from_origin": ArraySpec(np.float32, (-1,)),
      "info:x_velocity": ArraySpec(np.float32, (-1,)),
      "info:y_velocity": ArraySpec(np.float32, (-1,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float32, (-1, 17), -0.4, 0.4)}

  @classmethod
  def _mass_center(cls, xipos):
    mass = de.consts_on(cls.mdl(), xipos.dtype, xipos.device)["body_mass"]
    return (mass[:, None] * xipos).sum(1)[:, :2] / mass.sum()

  @classmethod
  def _derived(cls, qf, vf, fext):
    """(mc, cinert, cvel, cfrc_ext) at the last-forward state: cfrc_ext is
    the contact wrench translated from the world origin to com0."""
    com0, xipos, cinert, cvel = de.com_quantities(cls.mdl(), qf, vf)
    F = fext[..., 3:]
    trq = fext[..., :3] - torch.linalg.cross(com0[:, None].expand_as(F), F)
    return cls._mass_center(xipos), cinert, cvel, torch.cat([trq, F], -1)

  @classmethod
  def _obs_of(cls, q, v, cinert, cvel, qfrc_act, cfrc):
    return torch.cat([q[:, 2:], v, cinert.flatten(1), cvel.flatten(1),
                      qfrc_act, cfrc.flatten(1)], 1)

  @classmethod
  def _reset_state(cls, cfg: Any, keys: torch.Tensor):
    """The reset state and obs: mjData's derived fields are fresh after
    set_state's forward, and cfrc_ext and qfrc_actuator are zero."""
    mdl = cls.mdl()
    kq, kv = prng.split(keys).unbind(-2)
    s = float(cfg.reset_noise_scale)
    q = _qpos0(mdl, keys) + prng.uniform(kq, (mdl.nq,), -s, s)
    v = prng.uniform(kv, (mdl.nv,), -s, s)
    _, xipos, cinert, cvel = de.com_quantities(mdl, q, v)
    n = q.shape[0]
    obs = cls._obs_of(q, v, cinert, cvel, torch.zeros_like(v),
                      q.new_zeros(n, mdl.nbody, 6))
    return {"q": q, "v": v, "mc": cls._mass_center(xipos)}, obs

  @classmethod
  def reset(cls, cfg: Any, state: Any, keys: torch.Tensor):
    del state
    state, obs = cls._reset_state(cfg, keys)
    mc = state["mc"]
    zero = torch.zeros_like(mc[:, 0])
    return state, obs, {
      "reward_linvel": zero, "reward_quadctrl": zero, "reward_alive": zero,
      **_planar_info(mc[:, 0], mc[:, 1], zero, zero),
    }

  @classmethod
  def _physics_aux(cls, state, action):
    """The step and the derived fields of its last forward evaluation:
    (q, v, mc, obs)."""
    mdl = cls.mdl()
    q1, v1, (qf, vf, fext, _) = de.step_smooth(
      mdl, state["q"], state["v"], action, nstep=cls.frame_skip, want_aux=True,
    )
    mc, cinert, cvel, cfrc = cls._derived(qf, vf, fext)
    qfrc_act = de.actuator_force(mdl, action)
    return q1, v1, mc, cls._obs_of(q1, v1, cinert, cvel, qfrc_act, cfrc), cfrc

  @classmethod
  def step(cls, cfg: Any, state: Any, action: Any, keys: torch.Tensor):
    del keys
    mdl = cls.mdl()
    action = action.to(torch.float32)
    q1, v1, mc, obs, _ = cls._physics_aux(state, action)
    inv_dt = prng.inv32(cls.frame_skip * mdl.timestep)
    xv = (mc[:, 0] - state["mc"][:, 0]) * inv_dt
    yv = (mc[:, 1] - state["mc"][:, 1]) * inv_dt
    reward_linvel = float(cfg.forward_reward_weight) * xv
    ctrl_cost = float(cfg.ctrl_cost_weight) * (action * action).sum(-1)
    healthy = (q1[:, 2] > float(cfg.healthy_z_min)) & (
      q1[:, 2] < float(cfg.healthy_z_max))
    survive, term = _healthy_reward(cfg, healthy)
    reward = reward_linvel + survive - ctrl_cost
    return {"q": q1, "v": v1, "mc": mc}, obs, reward, term, {
      "reward_linvel": reward_linvel, "reward_quadctrl": -ctrl_cost,
      "reward_alive": survive,
      **_planar_info(mc[:, 0], mc[:, 1], xv, yv),
    }


class HumanoidStandupJaxEnv(HumanoidJaxEnv):
  """HumanoidStandup-v4 on-device
  (``envpool/mujoco/gym/humanoid_standup.h``)."""

  name = "HumanoidStandupJax"
  xml_file = "humanoidstandup.xml"
  frame_skip = 5

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {
      "forward_reward_weight": 1.0,
      "ctrl_cost_weight": 0.1,
      "contact_cost_weight": 5e-7, "contact_cost_max": 10.0,
      "healthy_reward": 1.0,
      "reset_noise_scale": 1e-2,
    }

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {
      "obs": ArraySpec(np.float32, (376,), -_INF, _INF),
      "info:reward_linup": ArraySpec(np.float32, (-1,)),
      "info:reward_quadctrl": ArraySpec(np.float32, (-1,)),
      "info:reward_impact": ArraySpec(np.float32, (-1,)),
      "info:reward_alive": ArraySpec(np.float32, (-1,)),
    }

  @classmethod
  def reset(cls, cfg: Any, state: Any, keys: torch.Tensor):
    del state
    state, obs = cls._reset_state(cfg, keys)
    zero = torch.zeros_like(state["mc"][:, 0])
    return state, obs, {
      "reward_linup": zero, "reward_quadctrl": zero,
      "reward_impact": zero, "reward_alive": zero,
    }

  @classmethod
  def step(cls, cfg: Any, state: Any, action: Any, keys: torch.Tensor):
    del keys
    mdl = cls.mdl()
    action = action.to(torch.float32)
    q1, v1, mc, obs, cfrc = cls._physics_aux(state, action)
    reward_linup = float(cfg.forward_reward_weight) * (
      q1[:, 2] * prng.inv32(mdl.timestep))
    ctrl_cost = float(cfg.ctrl_cost_weight) * (action * action).sum(-1)
    impact = torch.clamp_max(
      float(cfg.contact_cost_weight) * (cfrc * cfrc).sum((1, 2)),
      float(cfg.contact_cost_max))
    survive = torch.full_like(impact, float(cfg.healthy_reward))
    reward = reward_linup + survive - ctrl_cost - impact
    return {"q": q1, "v": v1, "mc": mc}, obs, reward, torch.zeros_like(reward, dtype=torch.bool), {
      "reward_linup": reward_linup, "reward_quadctrl": -ctrl_cost,
      "reward_impact": -impact, "reward_alive": survive,
    }


def _hypot32(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
  """float32 ``jnp.hypot`` as XLA-CPU computes it: hi sqrt(1 + (lo/hi)^2)
  with the square and the add contracted into one multiply-add, and a
  correctly rounded square root (torch's float32 CPU ``sqrt`` is off by an
  ulp on ~0.6% of the inputs, so it is taken in float64 and rounded)."""
  a, b = torch.abs(x), torch.abs(y)
  hi, lo = torch.maximum(a, b), torch.minimum(a, b)
  zero = hi == 0
  r = lo / torch.where(zero, 1.0, hi)
  root = torch.sqrt(prng.fma32(r, r, 1.0).double()).float()
  return torch.where(zero, hi, hi * root)


class PusherJaxEnv(DeviceMujocoEnv):
  """Pusher-v4 on-device (``envpool/mujoco/gym/pusher.h`` semantics): the
  engine's cylinder contacts (plane-cylinder and capsule-cylinder, all
  condim 1). The rewards are the pre-step near and dist costs from the
  body frame origins (``data_->xpos``), weights 0.5, 1.0 and 0.1.

  The reset draws the object's place as gym does, uniform on the box and
  redrawn until it is more than ``cylinder_dist_min`` from the goal: per
  lane, on its own key chain, as the JAX package's ``lax.while_loop``
  under ``vmap`` does, through ``graph.while_loop``: eagerly one flag
  read back per round (are all lanes placed?), in the reset only; inside a
  captured rollout a WHILE node.
  """

  name = "PusherJax"
  xml_file = "pusher.xml"
  frame_skip = 5

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {
      "reward_threshold": 0.0,
      "ctrl_cost_weight": 0.1,
      "dist_cost_weight": 1.0,
      "near_cost_weight": 0.5,
      "reset_qvel_scale": 0.005,
      "cylinder_x_min": -0.3, "cylinder_x_max": 0.0,
      "cylinder_y_min": -0.2, "cylinder_y_max": 0.2,
      "cylinder_dist_min": 0.17,
    }

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {
      "obs": ArraySpec(np.float32, (23,), -_INF, _INF),
      "info:reward_dist": ArraySpec(np.float32, (-1,)),
      "info:reward_ctrl": ArraySpec(np.float32, (-1,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float32, (-1, 7), -2.0, 2.0)}

  @classmethod
  def _bodies(cls, q):
    """The world positions of tips_arm, object and goal ``[N, 3]``, from one
    kinematics pass."""
    mdl = cls.mdl()
    xpos = de.fk(mdl, q)[0]
    return [xpos[mdl.body_name2id[b]] for b in ("tips_arm", "object", "goal")]

  @classmethod
  def _obs(cls, state):
    q, v = state["q"], state["v"]
    return torch.cat([q[:, :7], v[:, :7]] + cls._bodies(q), 1)

  @classmethod
  def reset(cls, cfg: Any, state: Any, keys: torch.Tensor):
    del state
    mdl = cls.mdl()
    kc, kv = prng.split(keys).unbind(-2)
    xlo, xhi = float(cfg.cylinder_x_min), float(cfg.cylinder_x_max)
    ylo, yhi = float(cfg.cylinder_y_min), float(cfg.cylinder_y_max)
    dmin = float(np.float32(cfg.cylinder_dist_min))
    x = torch.zeros(keys.shape[0], dtype=torch.float32, device=keys.device)
    y = torch.zeros_like(x)
    placed = torch.zeros_like(x, dtype=torch.bool)

    def draw_round(carry):
      x, y, kc, placed = carry
      kc_next, k1, k2 = prng.split(kc, 3).unbind(-2)
      xd = prng.uniform(k1, (), xlo, xhi)
      yd = prng.uniform(k2, (), ylo, yhi)
      draw = ~placed
      return (
        torch.where(draw, xd, x), torch.where(draw, yd, y),
        torch.where(draw[:, None], kc_next, kc),
        placed | (_hypot32(xd, yd) > dmin),
      )

    # the JAX reset's lax.while_loop: a WHILE node of the graph under capture
    x, y, _, _ = graph.while_loop(
      lambda carry: ~carry[3], draw_round, (x, y, kc, placed)
    )
    q = _qpos0(mdl, keys).expand(keys.shape[0], mdl.nq)
    zero = torch.zeros_like(q[:, :2])
    q = torch.cat([q[:, :-4], x[:, None], y[:, None], zero], 1)
    s = float(cfg.reset_qvel_scale)
    v = prng.uniform(kv, (mdl.nv,), -s, s)
    v = torch.cat([v[:, :-4], torch.zeros_like(v[:, -4:])], 1)
    state = {"q": q, "v": v}
    zero = torch.zeros_like(x)
    return state, cls._obs(state), {"reward_dist": zero, "reward_ctrl": zero}

  @classmethod
  def step(cls, cfg: Any, state: Any, action: Any, keys: torch.Tensor):
    del keys
    action = action.to(torch.float32)
    tips, obj, goal = cls._bodies(state["q"])
    near_cost = torch.sqrt(((obj - tips) ** 2).sum(-1))
    dist_cost = torch.sqrt(((obj - goal) ** 2).sum(-1))
    q1, v1 = cls._physics(state, action)
    state = {"q": q1, "v": v1}
    ctrl_cost = (action * action).sum(-1)
    reward = -(float(cfg.dist_cost_weight) * dist_cost
               + float(cfg.ctrl_cost_weight) * ctrl_cost
               + float(cfg.near_cost_weight) * near_cost)
    return state, cls._obs(state), reward, torch.zeros_like(reward, dtype=torch.bool), {
      "reward_dist": -dist_cost, "reward_ctrl": -ctrl_cost
    }
