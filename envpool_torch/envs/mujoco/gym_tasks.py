"""MuJoCo gym family of the port — host-native tier over raw ``mj_step``.

The port's copy of ``envpool_tpu/envs/mujoco/gym_tasks.py``.

Parity targets: ``envpool/mujoco/gym/*.h``. Like the reference (which links
libmujoco and re-implements each gym task's obs/reward/termination in C++,
``envpool/mujoco/gym/mujoco_env.h:44-94``), this module drives raw
``mujoco.mj_step`` per env and re-implements every task's logic —
gymnasium is used ONLY for its MJCF asset files. Envs run on the
HostEnvPool thread tier (MuJoCo releases the GIL inside mj_step), the
exact counterpart of the reference's worker-thread design; obs reach the
card through the pool's ``xla()`` bridge (page-locked staging buffers).

Per-task semantics (defaults, obs layout, reward terms, health checks,
reset noise) follow the cited reference headers line by line; all tasks are
registered as both -v3 and -v4 like ``envpool/mujoco/gym/registration.py``.
"""

from __future__ import annotations

import math
import os
from typing import Any, Dict

import numpy as np

from envpool_torch.core.host_pool import HostEnv
from envpool_torch.core.spec import ArraySpec

_INF = float("inf")
_MODEL_CACHE: Dict[str, Any] = {}


def _asset(name: str) -> str:
  import gymnasium
  return os.path.join(
    os.path.dirname(gymnasium.__file__), "envs", "mujoco", "assets", name
  )


def _load_model(xml: str) -> Any:
  import mujoco
  if xml not in _MODEL_CACHE:
    _MODEL_CACHE[xml] = mujoco.MjModel.from_xml_path(xml)
  return _MODEL_CACHE[xml]


class MujocoGymEnv(HostEnv):
  """Counterpart of ``mujoco_gym::MujocoEnv`` (mujoco_env.h:27-96)."""

  xml_file: str = ""

  def __init__(self, cfg: Any, env_id: int) -> None:
    super().__init__(cfg, env_id)
    import mujoco
    self._mujoco = mujoco
    self.model = _load_model(_asset(self.xml_file))
    self.data = mujoco.MjData(self.model)
    self.init_qpos = np.copy(self.data.qpos)
    self.init_qvel = np.copy(self.data.qvel)
    self.frame_skip = int(cfg.frame_skip)
    self.post_constraint = bool(cfg.post_constraint)
    self._dt = self.frame_skip * self.model.opt.timestep

  # -- the MujocoReset / MujocoStep primitives (mujoco_env.h:74-94)

  def mujoco_reset(self) -> None:
    self._mujoco.mj_resetData(self.model, self.data)
    self.reset_model()
    self._mujoco.mj_forward(self.model, self.data)

  def reset_model(self) -> None:
    raise NotImplementedError

  def mujoco_step(self, action: np.ndarray) -> None:
    self.data.ctrl[:] = action
    # one binding call for the whole frame_skip: mj_step releases the GIL
    # once for all substeps instead of re-acquiring it per frame
    self._mujoco.mj_step(self.model, self.data, nstep=self.frame_skip)
    if self.post_constraint:
      self._mujoco.mj_rnePostConstraint(self.model, self.data)

  @property
  def dt(self) -> float:
    return self._dt

  # convenience: uniform/normal noise with the env's generator

  def _unif(self, scale: float, n: int) -> np.ndarray:
    return self.gen.uniform(-scale, scale, n)

  def _norm(self, scale: float, n: int) -> np.ndarray:
    return self.gen.normal(0.0, scale, n)


# ---------------------------------------------------------------------- ant


class AntEnv(MujocoGymEnv):
  """Ant-v3/v4 (``envpool/mujoco/gym/ant.h:30-226``)."""

  name = "Ant"
  xml_file = "ant.xml"

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {
      "reward_threshold": 6000.0, "frame_skip": 5, "post_constraint": True,
      "use_contact_force": False, "terminate_when_unhealthy": True,
      "exclude_current_positions_from_observation": True,
      "forward_reward_weight": 1.0, "ctrl_cost_weight": 0.5,
      "contact_cost_weight": 5e-4, "healthy_reward": 1.0,
      "healthy_z_min": 0.2, "healthy_z_max": 1.0,
      "contact_force_min": -1.0, "contact_force_max": 1.0,
      "reset_noise_scale": 0.1,
    }

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    obs_n = 27 if cfg.exclude_current_positions_from_observation else 29
    if cfg.use_contact_force:
      obs_n += 14 * 6
    return {
      "obs": ArraySpec(np.float64, (obs_n,), -_INF, _INF),
      "info:reward_forward": ArraySpec(np.float64, (-1,)),
      "info:reward_ctrl": ArraySpec(np.float64, (-1,)),
      "info:reward_contact": ArraySpec(np.float64, (-1,)),
      "info:reward_survive": ArraySpec(np.float64, (-1,)),
      "info:x_position": ArraySpec(np.float64, (-1,)),
      "info:y_position": ArraySpec(np.float64, (-1,)),
      "info:distance_from_origin": ArraySpec(np.float64, (-1,)),
      "info:x_velocity": ArraySpec(np.float64, (-1,)),
      "info:y_velocity": ArraySpec(np.float64, (-1,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float64, (-1, 8), -1.0, 1.0)}

  def __init__(self, cfg: Any, env_id: int) -> None:
    super().__init__(cfg, env_id)
    self.id_torso = self._mujoco.mj_name2id(
      self.model, self._mujoco.mjtObj.mjOBJ_XBODY, "torso"
    )
    # hot-path constants hoisted off the per-step path (the host tier
    # is GIL-bound between mj_step calls; every boxed float counts)
    self._w_fwd = float(cfg.forward_reward_weight)
    self._w_ctrl = float(cfg.ctrl_cost_weight)
    self._w_contact = float(cfg.contact_cost_weight)
    self._w_healthy = float(cfg.healthy_reward)
    self._z_min = float(cfg.healthy_z_min)
    self._z_max = float(cfg.healthy_z_max)
    self._term_unhealthy = bool(cfg.terminate_when_unhealthy)
    self._use_cfrc = bool(cfg.use_contact_force)

  def reset_model(self) -> None:
    s = float(self.cfg.reset_noise_scale)
    self.data.qpos[:] = self.init_qpos + self._unif(s, self.model.nq)
    self.data.qvel[:] = self.init_qvel + self._norm(s, self.model.nv)

  def _healthy(self) -> bool:
    z = self.data.qpos[2]
    # one-pass finiteness: the sum is non-finite iff any element is
    # (inf+(-inf)=nan, nan propagates) — replaces two full
    # isfinite().all() reductions on the hot path
    chk = float(self.data.qpos.sum() + self.data.qvel.sum())
    return self._z_min <= z <= self._z_max and math.isfinite(chk)

  def _obs(self) -> np.ndarray:
    start = 2 if self.cfg.exclude_current_positions_from_observation else 0
    parts = [self.data.qpos[start:], self.data.qvel]
    if self.cfg.use_contact_force:
      parts.append(np.clip(
        self.data.cfrc_ext.ravel(),
        float(self.cfg.contact_force_min), float(self.cfg.contact_force_max),
      ))
    return np.concatenate(parts)

  def _info(self, xv=0.0, yv=0.0, ctrl=0.0, contact=0.0, survive=0.0):
    xy = self.data.xpos[self.id_torso]
    x, y = float(xy[0]), float(xy[1])
    return {
      "reward_forward": xv * self._w_fwd,
      "reward_ctrl": -ctrl, "reward_contact": -contact,
      "reward_survive": survive,
      "x_position": x, "y_position": y,
      "distance_from_origin": math.hypot(x, y),
      "x_velocity": xv, "y_velocity": yv,
    }

  def reset(self):
    self.mujoco_reset()
    return self._obs(), self._info()

  def step(self, action):
    xy = self.data.xpos[self.id_torso]
    x0, y0 = float(xy[0]), float(xy[1])
    self.mujoco_step(action)
    xv = (float(xy[0]) - x0) / self.dt
    yv = (float(xy[1]) - y0) / self.dt
    ctrl = self._w_ctrl * float(np.dot(action, action))
    contact = 0.0
    if self._use_cfrc:
      x = np.clip(
        self.data.cfrc_ext.ravel(),
        float(self.cfg.contact_force_min), float(self.cfg.contact_force_max),
      )
      contact = self._w_contact * float(np.sum(x * x))
    healthy = self._healthy()
    survive = (
      self._w_healthy if (self._term_unhealthy or healthy) else 0.0
    )
    reward = xv * self._w_fwd + survive - ctrl - contact
    term = self._term_unhealthy and not healthy
    return self._obs(), reward, term, self._info(xv, yv, ctrl, contact,
                                                 survive)


# -------------------------------------------------------------- half cheetah


class HalfCheetahEnv(MujocoGymEnv):
  """HalfCheetah-v3/v4 (``envpool/mujoco/gym/half_cheetah.h``)."""

  name = "HalfCheetah"
  xml_file = "half_cheetah.xml"

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {
      "reward_threshold": 4800.0, "frame_skip": 5, "post_constraint": True,
      "exclude_current_positions_from_observation": True,
      "ctrl_cost_weight": 0.1, "forward_reward_weight": 1.0,
      "reset_noise_scale": 0.1,
    }

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    obs_n = 17 if cfg.exclude_current_positions_from_observation else 18
    return {
      "obs": ArraySpec(np.float64, (obs_n,), -_INF, _INF),
      "info:reward_run": ArraySpec(np.float64, (-1,)),
      "info:reward_ctrl": ArraySpec(np.float64, (-1,)),
      "info:x_position": ArraySpec(np.float64, (-1,)),
      "info:x_velocity": ArraySpec(np.float64, (-1,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float64, (-1, 6), -1.0, 1.0)}

  def reset_model(self) -> None:
    s = float(self.cfg.reset_noise_scale)
    self.data.qpos[:] = self.init_qpos + self._unif(s, self.model.nq)
    self.data.qvel[:] = self.init_qvel + self._norm(s, self.model.nv)

  def _obs(self) -> np.ndarray:
    start = 1 if self.cfg.exclude_current_positions_from_observation else 0
    return np.concatenate([self.data.qpos[start:], self.data.qvel])

  def _info(self, xv=0.0, ctrl=0.0):
    return {
      "reward_run": xv * float(self.cfg.forward_reward_weight),
      "reward_ctrl": -ctrl,
      "x_position": float(self.data.qpos[0]),
      "x_velocity": xv,
    }

  def reset(self):
    self.mujoco_reset()
    return self._obs(), self._info()

  def step(self, action):
    x_before = float(self.data.qpos[0])
    self.mujoco_step(action)
    xv = (float(self.data.qpos[0]) - x_before) / self.dt
    ctrl = float(self.cfg.ctrl_cost_weight) * float(np.sum(action * action))
    reward = xv * float(self.cfg.forward_reward_weight) - ctrl
    return self._obs(), reward, False, self._info(xv, ctrl)


# -------------------------------------------------------------------- hopper


class HopperEnv(MujocoGymEnv):
  """Hopper-v3/v4 (``envpool/mujoco/gym/hopper.h``)."""

  name = "Hopper"
  xml_file = "hopper.xml"

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {
      "reward_threshold": 6000.0, "frame_skip": 4, "post_constraint": True,
      "terminate_when_unhealthy": True,
      "exclude_current_positions_from_observation": True,
      "ctrl_cost_weight": 1e-3, "forward_reward_weight": 1.0,
      "healthy_reward": 1.0, "velocity_min": -10.0, "velocity_max": 10.0,
      "healthy_state_min": -100.0, "healthy_state_max": 100.0,
      "healthy_angle_min": -0.2, "healthy_angle_max": 0.2,
      "healthy_z_min": 0.7, "reset_noise_scale": 5e-3,
    }

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    obs_n = 11 if cfg.exclude_current_positions_from_observation else 12
    return {
      "obs": ArraySpec(np.float64, (obs_n,), -_INF, _INF),
      "info:x_position": ArraySpec(np.float64, (-1,)),
      "info:x_velocity": ArraySpec(np.float64, (-1,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float64, (-1, 3), -1.0, 1.0)}

  def reset_model(self) -> None:
    s = float(self.cfg.reset_noise_scale)
    self.data.qpos[:] = self.init_qpos + self._unif(s, self.model.nq)
    self.data.qvel[:] = self.init_qvel + self._unif(s, self.model.nv)

  def _healthy(self) -> bool:
    cfg = self.cfg
    z, angle = self.data.qpos[1], self.data.qpos[2]
    if (
      angle <= float(cfg.healthy_angle_min)
      or angle >= float(cfg.healthy_angle_max)
      or z <= float(cfg.healthy_z_min)
    ):
      return False
    lo, hi = float(cfg.healthy_state_min), float(cfg.healthy_state_max)
    state = np.concatenate([self.data.qpos[2:], self.data.qvel])
    return bool(np.all((state > lo) & (state < hi)))

  def _obs(self) -> np.ndarray:
    cfg = self.cfg
    start = 1 if cfg.exclude_current_positions_from_observation else 0
    return np.concatenate([
      self.data.qpos[start:],
      np.clip(self.data.qvel, float(cfg.velocity_min),
              float(cfg.velocity_max)),
    ])

  def _info(self, xv=0.0):
    return {"x_position": float(self.data.qpos[0]), "x_velocity": xv}

  def reset(self):
    self.mujoco_reset()
    return self._obs(), self._info()

  def step(self, action):
    cfg = self.cfg
    x_before = float(self.data.qpos[0])
    self.mujoco_step(action)
    xv = (float(self.data.qpos[0]) - x_before) / self.dt
    ctrl = float(cfg.ctrl_cost_weight) * float(np.sum(action * action))
    healthy = self._healthy()
    survive = (
      float(cfg.healthy_reward)
      if (cfg.terminate_when_unhealthy or healthy) else 0.0
    )
    reward = xv * float(cfg.forward_reward_weight) + survive - ctrl
    term = bool(cfg.terminate_when_unhealthy) and not healthy
    return self._obs(), reward, term, self._info(xv)


# ------------------------------------------------------------------ walker2d


class Walker2dEnv(MujocoGymEnv):
  """Walker2d-v3/v4 (``envpool/mujoco/gym/walker2d.h``)."""

  name = "Walker2d"
  xml_file = "walker2d.xml"

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {
      "frame_skip": 4, "post_constraint": True, "ctrl_cost_weight": 1e-3,
      "terminate_when_unhealthy": True,
      "exclude_current_positions_from_observation": True,
      "forward_reward_weight": 1.0, "healthy_reward": 1.0,
      "healthy_z_min": 0.8, "healthy_z_max": 2.0,
      "healthy_angle_min": -1.0, "healthy_angle_max": 1.0,
      "velocity_min": -10.0, "velocity_max": 10.0,
      "reset_noise_scale": 5e-3,
    }

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    # walker2d.xml has nq=9/nv=9 -> 17-dim obs (walker2d.h:48)
    obs_n = 17 if cfg.exclude_current_positions_from_observation else 18
    return {
      "obs": ArraySpec(np.float64, (obs_n,), -_INF, _INF),
      "info:x_position": ArraySpec(np.float64, (-1,)),
      "info:x_velocity": ArraySpec(np.float64, (-1,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float64, (-1, 6), -1.0, 1.0)}

  reset_model = HopperEnv.reset_model
  _obs = HopperEnv._obs
  _info = HopperEnv._info
  reset = HopperEnv.reset
  step = HopperEnv.step

  def _healthy(self) -> bool:
    cfg = self.cfg
    z, angle = self.data.qpos[1], self.data.qpos[2]
    return bool(
      float(cfg.healthy_z_min) <= z <= float(cfg.healthy_z_max)
      and float(cfg.healthy_angle_min) <= angle
      <= float(cfg.healthy_angle_max)
    )


# ------------------------------------------------------------------- swimmer


class SwimmerEnv(MujocoGymEnv):
  """Swimmer-v3/v4 (``envpool/mujoco/gym/swimmer.h``)."""

  name = "Swimmer"
  xml_file = "swimmer.xml"

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {
      "reward_threshold": 360.0, "frame_skip": 4, "post_constraint": True,
      "exclude_current_positions_from_observation": True,
      "forward_reward_weight": 1.0, "ctrl_cost_weight": 1e-4,
      "reset_noise_scale": 0.1,
    }

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    obs_n = 8 if cfg.exclude_current_positions_from_observation else 10
    return {
      "obs": ArraySpec(np.float64, (obs_n,), -_INF, _INF),
      "info:reward_fwd": ArraySpec(np.float64, (-1,)),
      "info:reward_ctrl": ArraySpec(np.float64, (-1,)),
      "info:x_position": ArraySpec(np.float64, (-1,)),
      "info:y_position": ArraySpec(np.float64, (-1,)),
      "info:distance_from_origin": ArraySpec(np.float64, (-1,)),
      "info:x_velocity": ArraySpec(np.float64, (-1,)),
      "info:y_velocity": ArraySpec(np.float64, (-1,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float64, (-1, 2), -1.0, 1.0)}

  def reset_model(self) -> None:
    s = float(self.cfg.reset_noise_scale)
    self.data.qpos[:] = self.init_qpos + self._unif(s, self.model.nq)
    self.data.qvel[:] = self.init_qvel + self._unif(s, self.model.nv)

  def _obs(self) -> np.ndarray:
    start = 2 if self.cfg.exclude_current_positions_from_observation else 0
    return np.concatenate([self.data.qpos[start:], self.data.qvel])

  def _info(self, xv=0.0, yv=0.0, ctrl=0.0):
    x, y = float(self.data.qpos[0]), float(self.data.qpos[1])
    return {
      "reward_fwd": xv * float(self.cfg.forward_reward_weight),
      "reward_ctrl": -ctrl,
      "x_position": x, "y_position": y,
      "distance_from_origin": float(np.hypot(x, y)),
      "x_velocity": xv, "y_velocity": yv,
    }

  def reset(self):
    self.mujoco_reset()
    return self._obs(), self._info()

  def step(self, action):
    xy_before = np.copy(self.data.qpos[:2])
    self.mujoco_step(action)
    xv, yv = (self.data.qpos[:2] - xy_before) / self.dt
    ctrl = float(self.cfg.ctrl_cost_weight) * float(np.sum(action * action))
    reward = xv * float(self.cfg.forward_reward_weight) - ctrl
    return self._obs(), reward, False, self._info(xv, yv, ctrl)


# ------------------------------------------------------------------- reacher


class ReacherEnv(MujocoGymEnv):
  """Reacher-v2(v4 semantics) (``envpool/mujoco/gym/reacher.h``)."""

  name = "Reacher"
  xml_file = "reacher.xml"

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {
      "reward_threshold": -3.75, "frame_skip": 2, "post_constraint": True,
      "ctrl_cost_weight": 1.0, "dist_cost_weight": 1.0,
      "reset_qpos_scale": 0.1, "reset_qvel_scale": 0.005,
      "reset_goal_scale": 0.2,
    }

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {
      "obs": ArraySpec(np.float64, (11,), -_INF, _INF),
      "info:reward_dist": ArraySpec(np.float64, (-1,)),
      "info:reward_ctrl": ArraySpec(np.float64, (-1,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float64, (-1, 2), -1.0, 1.0)}

  def __init__(self, cfg: Any, env_id: int) -> None:
    super().__init__(cfg, env_id)
    obj = self._mujoco.mjtObj.mjOBJ_XBODY
    self.id_fingertip = self._mujoco.mj_name2id(self.model, obj, "fingertip")
    self.id_target = self._mujoco.mj_name2id(self.model, obj, "target")

  def reset_model(self) -> None:
    cfg = self.cfg
    nq, nv = self.model.nq, self.model.nv
    self.data.qpos[:] = self.init_qpos + self._unif(
      float(cfg.reset_qpos_scale), nq
    )
    gs = float(cfg.reset_goal_scale)
    while True:
      x = self.gen.uniform(-gs, gs)
      y = self.gen.uniform(-gs, gs)
      if np.hypot(x, y) < gs:
        self.data.qpos[nq - 2] = x
        self.data.qpos[nq - 1] = y
        break
    qvel = self.init_qvel + self._unif(float(cfg.reset_qvel_scale), nv)
    qvel[nv - 2:] = 0.0
    self.data.qvel[:] = qvel

  def _dist(self) -> np.ndarray:
    return (
      self.data.xpos[self.id_fingertip] - self.data.xpos[self.id_target]
    )

  def _obs(self) -> np.ndarray:
    q = self.data.qpos
    return np.concatenate([
      [np.cos(q[0]), np.cos(q[1]), np.sin(q[0]), np.sin(q[1])],
      q[2:],
      self.data.qvel[:2],
      self._dist(),
    ])

  def reset(self):
    self.mujoco_reset()
    return self._obs(), {"reward_dist": 0.0, "reward_ctrl": 0.0}

  def step(self, action):
    cfg = self.cfg
    dist = self._dist()  # distance BEFORE stepping (reacher.h:115-118)
    self.mujoco_step(action)
    dist_cost = float(cfg.dist_cost_weight) * float(np.linalg.norm(dist))
    ctrl_cost = float(cfg.ctrl_cost_weight) * float(np.sum(action * action))
    reward = -dist_cost - ctrl_cost
    return self._obs(), reward, False, {
      "reward_dist": -dist_cost, "reward_ctrl": -ctrl_cost
    }


# -------------------------------------------------------------------- pusher


class PusherEnv(MujocoGymEnv):
  """Pusher-v2(v4 semantics) (``envpool/mujoco/gym/pusher.h``)."""

  name = "Pusher"
  xml_file = "pusher.xml"

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {
      "reward_threshold": 0.0, "frame_skip": 5, "post_constraint": True,
      "ctrl_cost_weight": 0.1, "dist_cost_weight": 1.0,
      "near_cost_weight": 0.5, "reset_qvel_scale": 0.005,
      "cylinder_x_min": -0.3, "cylinder_x_max": 0.0,
      "cylinder_y_min": -0.2, "cylinder_y_max": 0.2,
      "cylinder_dist_min": 0.17,
    }

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {
      "obs": ArraySpec(np.float64, (23,), -_INF, _INF),
      "info:reward_dist": ArraySpec(np.float64, (-1,)),
      "info:reward_ctrl": ArraySpec(np.float64, (-1,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float64, (-1, 7), -2.0, 2.0)}

  def __init__(self, cfg: Any, env_id: int) -> None:
    super().__init__(cfg, env_id)
    obj = self._mujoco.mjtObj.mjOBJ_XBODY
    self.id_tips_arm = self._mujoco.mj_name2id(self.model, obj, "tips_arm")
    self.id_object = self._mujoco.mj_name2id(self.model, obj, "object")
    self.id_goal = self._mujoco.mj_name2id(self.model, obj, "goal")

  def reset_model(self) -> None:
    cfg = self.cfg
    nq, nv = self.model.nq, self.model.nv
    self.data.qpos[:] = self.init_qpos
    while True:
      x = self.gen.uniform(float(cfg.cylinder_x_min),
                           float(cfg.cylinder_x_max))
      y = self.gen.uniform(float(cfg.cylinder_y_min),
                           float(cfg.cylinder_y_max))
      if np.hypot(x, y) > float(cfg.cylinder_dist_min):
        self.data.qpos[nq - 4] = x
        self.data.qpos[nq - 3] = y
        self.data.qpos[nq - 2] = 0.0
        self.data.qpos[nq - 1] = 0.0
        break
    qvel = self.init_qvel + self._unif(float(cfg.reset_qvel_scale), nv)
    qvel[nv - 4:] = 0.0
    self.data.qvel[:] = qvel

  def _gd(self, a: int, b: int) -> float:
    return float(np.linalg.norm(self.data.xpos[a] - self.data.xpos[b]))

  def _obs(self) -> np.ndarray:
    return np.concatenate([
      self.data.qpos[:7],
      self.data.qvel[:7],
      self.data.xpos[self.id_tips_arm],
      self.data.xpos[self.id_object],
      self.data.xpos[self.id_goal],
    ])

  def reset(self):
    self.mujoco_reset()
    return self._obs(), {"reward_dist": 0.0, "reward_ctrl": 0.0}

  def step(self, action):
    cfg = self.cfg
    near_cost = self._gd(self.id_object, self.id_tips_arm)
    dist_cost = self._gd(self.id_object, self.id_goal)
    self.mujoco_step(action)
    ctrl_cost = float(np.sum(action * action))
    reward = (
      -ctrl_cost * float(cfg.ctrl_cost_weight)
      - dist_cost * float(cfg.dist_cost_weight)
      - near_cost * float(cfg.near_cost_weight)
    )
    return self._obs(), reward, False, {
      "reward_dist": -dist_cost, "reward_ctrl": -ctrl_cost
    }


# -------------------------------------------------------- inverted pendulums


class InvertedPendulumEnv(MujocoGymEnv):
  """InvertedPendulum-v2(v4) (``envpool/mujoco/gym/inverted_pendulum.h``)."""

  name = "InvertedPendulum"
  xml_file = "inverted_pendulum.xml"

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {
      "reward_threshold": 950.0, "frame_skip": 2, "post_constraint": True,
      "healthy_reward": 1.0, "healthy_z_min": -0.2, "healthy_z_max": 0.2,
      "reset_noise_scale": 0.01,
    }

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"obs": ArraySpec(np.float64, (4,), -_INF, _INF)}

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float64, (-1, 1), -3.0, 3.0)}

  def reset_model(self) -> None:
    s = float(self.cfg.reset_noise_scale)
    self.data.qpos[:] = self.init_qpos + self._unif(s, self.model.nq)
    self.data.qvel[:] = self.init_qvel + self._unif(s, self.model.nv)

  def _healthy(self) -> bool:
    z = self.data.qpos[1]
    return bool(
      np.isfinite(self.data.qpos).all()
      and np.isfinite(self.data.qvel).all()
      and float(self.cfg.healthy_z_min) < z < float(self.cfg.healthy_z_max)
    )

  def _obs(self) -> np.ndarray:
    return np.concatenate([self.data.qpos, self.data.qvel])

  def reset(self):
    self.mujoco_reset()
    return self._obs(), {}

  def step(self, action):
    self.mujoco_step(action)
    return (
      self._obs(), float(self.cfg.healthy_reward), not self._healthy(), {}
    )


class InvertedDoublePendulumEnv(MujocoGymEnv):
  """InvertedDoublePendulum-v2(v4)
  (``envpool/mujoco/gym/inverted_double_pendulum.h``)."""

  name = "InvertedDoublePendulum"
  xml_file = "inverted_double_pendulum.xml"

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {
      "reward_threshold": 9100.0, "frame_skip": 5, "post_constraint": True,
      "healthy_reward": 10.0, "healthy_z_max": 1.0,
      "observation_min": -10.0, "observation_max": 10.0,
      "reset_noise_scale": 0.1,
    }

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"obs": ArraySpec(np.float64, (11,), -_INF, _INF)}

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float64, (-1, 1), -1.0, 1.0)}

  def reset_model(self) -> None:
    s = float(self.cfg.reset_noise_scale)
    self.data.qpos[:] = self.init_qpos + self._unif(s, self.model.nq)
    self.data.qvel[:] = self.init_qvel + self._norm(s, self.model.nv)

  def _obs(self) -> np.ndarray:
    cfg = self.cfg
    lo, hi = float(cfg.observation_min), float(cfg.observation_max)
    q = self.data.qpos
    return np.concatenate([
      [q[0], np.sin(q[1]), np.sin(q[2]), np.cos(q[1]), np.cos(q[2])],
      np.clip(self.data.qvel, lo, hi),
      np.clip(self.data.qfrc_constraint[:self.model.nv], lo, hi),
    ])

  def reset(self):
    self.mujoco_reset()
    return self._obs(), {}

  def step(self, action):
    self.mujoco_step(action)
    x = self.data.site_xpos[0][0]
    y = self.data.site_xpos[0][2]
    dist_penalty = 0.01 * x * x + (y - 2) * (y - 2)
    v1, v2 = self.data.qvel[1], self.data.qvel[2]
    vel_penalty = 1e-3 * v1 * v1 + 5e-3 * v2 * v2
    reward = float(self.cfg.healthy_reward) - dist_penalty - vel_penalty
    term = not (y > float(self.cfg.healthy_z_max))
    return self._obs(), float(reward), bool(term), {}


# ------------------------------------------------------------------ humanoid


class HumanoidEnv(MujocoGymEnv):
  """Humanoid-v3/v4 (``envpool/mujoco/gym/humanoid.h``)."""

  name = "Humanoid"
  xml_file = "humanoid.xml"

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {
      "frame_skip": 5, "post_constraint": True, "use_contact_force": False,
      "forward_reward_weight": 1.25, "terminate_when_unhealthy": True,
      "exclude_current_positions_from_observation": True,
      "ctrl_cost_weight": 0.1, "healthy_reward": 5.0,
      "healthy_z_min": 1.0, "healthy_z_max": 2.0,
      "contact_cost_weight": 5e-7, "contact_cost_max": 10.0,
      "reset_noise_scale": 1e-2,
    }

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    # humanoid.xml: nq=24, nv=23, nbody=14 -> 376 (v4 obs size)
    obs_n = (22 if cfg.exclude_current_positions_from_observation else 24)
    obs_n += 23 + 10 * 14 + 6 * 14 + 23 + 6 * 14
    return {
      "obs": ArraySpec(np.float64, (obs_n,), -_INF, _INF),
      "info:reward_linvel": ArraySpec(np.float64, (-1,)),
      "info:reward_quadctrl": ArraySpec(np.float64, (-1,)),
      "info:reward_alive": ArraySpec(np.float64, (-1,)),
      "info:reward_impact": ArraySpec(np.float64, (-1,)),
      "info:x_position": ArraySpec(np.float64, (-1,)),
      "info:y_position": ArraySpec(np.float64, (-1,)),
      "info:distance_from_origin": ArraySpec(np.float64, (-1,)),
      "info:x_velocity": ArraySpec(np.float64, (-1,)),
      "info:y_velocity": ArraySpec(np.float64, (-1,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float64, (-1, 17), -0.4, 0.4)}

  def reset_model(self) -> None:
    s = float(self.cfg.reset_noise_scale)
    self.data.qpos[:] = self.init_qpos + self._unif(s, self.model.nq)
    self.data.qvel[:] = self.init_qvel + self._unif(s, self.model.nv)

  def _mass_center(self) -> np.ndarray:
    mass = self.model.body_mass
    return (mass[:, None] * self.data.xipos).sum(0)[:2] / mass.sum()

  def _healthy(self) -> bool:
    z = self.data.qpos[2]
    return bool(
      float(self.cfg.healthy_z_min) < z < float(self.cfg.healthy_z_max)
    )

  def _obs(self) -> np.ndarray:
    start = 2 if self.cfg.exclude_current_positions_from_observation else 0
    return np.concatenate([
      self.data.qpos[start:],
      self.data.qvel,
      self.data.cinert.ravel(),
      self.data.cvel.ravel(),
      self.data.qfrc_actuator,
      self.data.cfrc_ext.ravel(),
    ])

  def _info(self, xv=0.0, yv=0.0, ctrl=0.0, contact=0.0, survive=0.0):
    x, y = self._mass_center()
    return {
      "reward_linvel": xv * float(self.cfg.forward_reward_weight),
      "reward_quadctrl": -ctrl, "reward_alive": survive,
      "reward_impact": -contact,
      "x_position": float(x), "y_position": float(y),
      "distance_from_origin": float(np.hypot(x, y)),
      "x_velocity": xv, "y_velocity": yv,
    }

  def reset(self):
    self.mujoco_reset()
    return self._obs(), self._info()

  def step(self, action):
    cfg = self.cfg
    before = self._mass_center()
    self.mujoco_step(action)
    after = self._mass_center()
    xv, yv = (after - before) / self.dt
    ctrl = float(cfg.ctrl_cost_weight) * float(np.sum(action * action))
    contact = 0.0
    if cfg.use_contact_force:
      x = self.data.cfrc_ext.ravel()
      contact = min(
        float(cfg.contact_cost_weight) * float(np.sum(x * x)),
        float(cfg.contact_cost_max),
      )
    healthy = self._healthy()
    survive = (
      float(cfg.healthy_reward)
      if (cfg.terminate_when_unhealthy or healthy) else 0.0
    )
    reward = (
      xv * float(cfg.forward_reward_weight) + survive - ctrl - contact
    )
    term = bool(cfg.terminate_when_unhealthy) and not healthy
    return self._obs(), reward, term, self._info(xv, yv, ctrl, contact,
                                                 survive)


class HumanoidStandupEnv(MujocoGymEnv):
  """HumanoidStandup-v2(v4) (``envpool/mujoco/gym/humanoid_standup.h``)."""

  name = "HumanoidStandup"
  xml_file = "humanoidstandup.xml"

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {
      "frame_skip": 5, "post_constraint": True,
      "forward_reward_weight": 1.0,
      "exclude_current_positions_from_observation": True,
      "ctrl_cost_weight": 0.1, "contact_cost_weight": 5e-7,
      "contact_cost_max": 10.0, "healthy_reward": 1.0,
      "reset_noise_scale": 1e-2,
    }

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    obs_n = (22 if cfg.exclude_current_positions_from_observation else 24)
    obs_n += 23 + 10 * 14 + 6 * 14 + 23 + 6 * 14
    return {
      "obs": ArraySpec(np.float64, (obs_n,), -_INF, _INF),
      "info:reward_linup": ArraySpec(np.float64, (-1,)),
      "info:reward_quadctrl": ArraySpec(np.float64, (-1,)),
      "info:reward_impact": ArraySpec(np.float64, (-1,)),
      "info:reward_alive": ArraySpec(np.float64, (-1,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float64, (-1, 17), -0.4, 0.4)}

  reset_model = HumanoidEnv.reset_model
  _obs = HumanoidEnv._obs

  def reset(self):
    self.mujoco_reset()
    return self._obs(), {
      "reward_linup": 0.0, "reward_quadctrl": 0.0,
      "reward_impact": 0.0, "reward_alive": 0.0,
    }

  def step(self, action):
    cfg = self.cfg
    self.mujoco_step(action)
    ctrl = float(cfg.ctrl_cost_weight) * float(np.sum(action * action))
    xv = float(self.data.qpos[2]) / float(self.model.opt.timestep)
    x = self.data.cfrc_ext.ravel()
    contact = min(
      float(cfg.contact_cost_weight) * float(np.sum(x * x)),
      float(cfg.contact_cost_max),
    )
    reward = (
      xv * float(cfg.forward_reward_weight) + float(cfg.healthy_reward)
      - ctrl - contact
    )
    return self._obs(), reward, False, {
      "reward_linup": xv * float(cfg.forward_reward_weight),
      "reward_quadctrl": -ctrl,
      "reward_impact": -contact,
      "reward_alive": float(cfg.healthy_reward),
    }
