"""On-device MuJoCo gym tasks (``-Jax-v4``), the port's batched versions.

Counterpart of ``envpool_tpu/envs/mujoco/device_tasks.py`` for the four
contact-free tasks: ``ReacherJax-v4``, ``InvertedPendulumJax-v4``,
``InvertedDoublePendulumJax-v4`` and ``SwimmerJax-v4``. Same names, models,
``frame_skip``, configs, specs, state keys ``{"q", "v"}``, key use,
observations, rewards, info fields and termination as the JAX package,
which follows the v4 generation of ``envpool/mujoco/gym/{reacher,
inverted_pendulum,inverted_double_pendulum,swimmer}.h``; written over
``[N, ...]`` tensors on the engine of ``device_engine.py``, with the
models loaded from the committed data (``device_model.load_model``).

Known deviations from the host/gym implementation (documented contract):
- RNG streams are jax.random, not MT19937 — reset noise is identically
  *distributed*, not bit-identical (SURVEY §7 hard part #1);
- Reacher's goal rejection-sampling loop is replaced by an exact uniform
  polar draw on the same open disk (identical distribution, no loop);
- InvertedDoublePendulum's ``qfrc_constraint`` obs slice is computed at
  the post-step state; gym reports the value MuJoCo cached from the last
  substep's pre-integration forward pass. Both are exactly zero whenever
  the cart's rail limit is inactive, i.e. in the entire healthy regime.

The contact tasks (HalfCheetah, Hopper, Walker2d, Ant, Humanoid,
HumanoidStandup, Pusher) come with the contact engine.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from envpool_torch.core import prng
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
