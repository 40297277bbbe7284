"""dm_control-suite host domains of the port (task logic from the reference
headers), the port's copy of ``envpool_tpu/envs/mujoco/dmc/domains.py``.

Each class reproduces the corresponding ``envpool/mujoco/dmc/<domain>.h``
observation layout, episode initialization and reward exactly; the MJCF
models are the replicas in ``assets.py``.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np

from envpool_torch.core.spec import ArraySpec

from . import assets
from .base import DmcEnv
from .rewards import LINEAR, LONG_TAIL, QUADRATIC, tolerance

_INF = float("inf")


class DmcPendulumEnv(DmcEnv):
  """dmc pendulum swingup (``envpool/mujoco/dmc/pendulum.h``)."""

  name = "DmcPendulum"
  model_xml = assets.PENDULUM_XML
  _COS_BOUND = math.cos(8.0 / 180 * math.pi)

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"frame_skip": 1, "task_name": "swingup"}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {
      "obs:orientation": ArraySpec(np.float64, (2,)),
      "obs:velocity": ArraySpec(np.float64, (1,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float64, (-1, 1), -1.0, 1.0)}

  def __init__(self, cfg: Any, env_id: int) -> None:
    super().__init__(cfg, env_id)
    if self.task_name != "swingup":
      raise RuntimeError(
        f"Unknown task_name {self.task_name} for dmc pendulum."
      )
    self.id_pole = self.body_id("pole")
    self.id_hinge = self.qvel_id("hinge")

  def task_initialize_episode(self) -> None:
    self.data.qpos[0] = self.gen.uniform(-math.pi, math.pi)

  def task_get_reward(self) -> float:
    zz = self.data.xmat[self.id_pole].reshape(3, 3)[2, 2]
    return tolerance(zz, self._COS_BOUND, 1.0)

  def task_observation(self) -> Dict[str, np.ndarray]:
    xmat = self.data.xmat[self.id_pole].reshape(3, 3)
    return {
      "orientation": np.asarray([xmat[2, 2], xmat[0, 2]]),
      "velocity": np.asarray([self.data.qvel[self.id_hinge]]),
    }


class DmcCartpoleEnv(DmcEnv):
  """dmc cartpole (``envpool/mujoco/dmc/cartpole.h``)."""

  name = "DmcCartpole"
  model_xml = staticmethod(assets.cartpole_xml)

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"frame_skip": 1, "task_name": "balance"}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    task = str(cfg.task_name)
    n = {"two_poles": 2, "three_poles": 3}.get(task, 1)
    if task not in (
      "balance", "balance_sparse", "swingup", "swingup_sparse",
      "two_poles", "three_poles",
    ):
      raise RuntimeError(f"Unknown task_name {task} for dmc cartpole.")
    return {
      "obs:position": ArraySpec(np.float64, (1 + 2 * n,)),
      "obs:velocity": ArraySpec(np.float64, (1 + n,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float64, (-1, 1), -1.0, 1.0)}

  def __init__(self, cfg: Any, env_id: int) -> None:
    super().__init__(cfg, env_id)
    t = self.task_name
    self.is_sparse = t in ("balance_sparse", "swingup_sparse")
    self.is_swingup = t in (
      "swingup", "swingup_sparse", "two_poles", "three_poles"
    )
    self.id_slider = self.qpos_id("slider")
    self.id_hinge1 = self.qpos_id("hinge_1")

  def task_initialize_episode(self) -> None:
    # cartpole.h:121-137
    if self.is_swingup:
      self.data.qpos[self.id_slider] = self.gen.normal(0, 0.01)
      self.data.qpos[self.id_hinge1] = self.gen.normal(math.pi, 0.01)
      for i in range(2, self.model.nq):
        self.data.qpos[i] = self.gen.normal(0, 0.01)
    else:
      self.data.qpos[self.id_slider] = self.gen.uniform(-0.1, 0.1)
      for i in range(1, self.model.nq):
        self.data.qpos[i] = self.gen.uniform(-0.034, 0.034)
    for i in range(self.model.nv):
      self.data.qvel[i] = self.gen.normal(0, 0.01)

  def _pole_angle_cosine(self) -> np.ndarray:
    return np.asarray([
      self.data.xmat[i].reshape(3, 3)[2, 2]
      for i in range(2, self.model.nbody)
    ])

  def task_get_reward(self) -> float:
    # cartpole.h:152-183
    cart = self.data.qpos[self.id_slider]
    cosines = self._pole_angle_cosine()
    if self.is_sparse:
      cart_in_bounds = tolerance(cart, -0.25, 0.25)
      angle_in_bounds = 1.0
      for x in cosines:
        angle_in_bounds *= tolerance(x, 0.995, 1.0)
      return float(cart_in_bounds * angle_in_bounds)
    upright = float(np.mean((cosines + 1) / 2))
    centered = (1 + tolerance(cart, 0.0, 0.0, 2.0)) / 2
    small_control = (
      tolerance(self.data.ctrl[0], 0.0, 0.0, 1.0, 0.0, QUADRATIC) + 4
    ) / 5
    small_velocity = min(
      tolerance(v, 0.0, 0.0, 5.0) for v in self.data.qvel[1:]
    )
    small_velocity = (small_velocity + 1) / 2
    return float(upright * small_control * small_velocity * centered)

  def task_observation(self) -> Dict[str, np.ndarray]:
    pos = [self.data.qpos[self.id_slider]]
    for i in range(2, self.model.nbody):
      xmat = self.data.xmat[i].reshape(3, 3)
      pos += [xmat[2, 2], xmat[0, 2]]
    return {
      "position": np.asarray(pos),
      "velocity": np.copy(self.data.qvel),
    }


class DmcPointMassEnv(DmcEnv):
  """dmc point_mass easy/hard (``envpool/mujoco/dmc/point_mass.h``)."""

  name = "DmcPointMass"
  model_xml = assets.POINT_MASS_XML

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"frame_skip": 1, "task_name": "easy"}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {
      "obs:position": ArraySpec(np.float64, (2,)),
      "obs:velocity": ArraySpec(np.float64, (2,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float64, (-1, 2), -1.0, 1.0)}

  def __init__(self, cfg: Any, env_id: int) -> None:
    super().__init__(cfg, env_id)
    if self.task_name not in ("easy", "hard"):
      raise RuntimeError(
        f"Unknown task_name {self.task_name} for dmc point_mass."
      )
    self.randomize_gains = self.task_name == "hard"
    self.id_target = self.geom_id("target")
    self.id_pointmass = self.geom_id("pointmass")

  def _dir(self) -> np.ndarray:
    d = self.gen.normal(0, 1, 2)
    return d / np.linalg.norm(d)

  def task_initialize_episode(self) -> None:
    self.randomize_limited_and_rotational_joints()
    if self.randomize_gains:
      dir1 = self._dir()
      while True:
        dir2 = self._dir()
        if abs(float(dir1 @ dir2)) <= 0.9:
          break
      self.model.wrap_prm[0:2] = dir1
      self.model.wrap_prm[2:4] = dir2

  def task_get_reward(self) -> float:
    target_size = float(self.model.geom_size[self.id_target, 0])
    d = self.data.geom_xpos[self.id_target] - self.data.geom_xpos[
      self.id_pointmass
    ]
    near = tolerance(float(np.linalg.norm(d)), 0, target_size, target_size)
    control = (
      tolerance(self.data.ctrl[0], 0, 0, 1, 0, QUADRATIC)
      + tolerance(self.data.ctrl[1], 0, 0, 1, 0, QUADRATIC)
    ) / 2
    small_control = (control + 4) / 5
    return float(near * small_control)

  def task_observation(self) -> Dict[str, np.ndarray]:
    return {
      "position": np.copy(self.data.qpos),
      "velocity": np.copy(self.data.qvel),
    }


class DmcReacherEnv(DmcEnv):
  """dmc reacher easy/hard (``envpool/mujoco/dmc/reacher.h``)."""

  name = "DmcReacher"
  model_xml = assets.REACHER_XML
  _BIG_TARGET = 0.05
  _SMALL_TARGET = 0.015

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"frame_skip": 1, "task_name": "easy"}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {
      "obs:position": ArraySpec(np.float64, (2,)),
      "obs:to_target": ArraySpec(np.float64, (2,)),
      "obs:velocity": ArraySpec(np.float64, (2,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float64, (-1, 2), -1.0, 1.0)}

  def __init__(self, cfg: Any, env_id: int) -> None:
    super().__init__(cfg, env_id)
    if self.task_name not in ("easy", "hard"):
      raise RuntimeError(
        f"Unknown task_name {self.task_name} for dmc reacher."
      )
    self.target_size = (
      self._BIG_TARGET if self.task_name == "easy" else self._SMALL_TARGET
    )
    self.id_target = self.geom_id("target")
    self.id_finger = self.geom_id("finger")

  def task_initialize_episode(self) -> None:
    self.model.geom_size[self.id_target, 0] = self.target_size
    self.randomize_limited_and_rotational_joints()
    angle = self.gen.uniform(0, 2 * math.pi)
    radius = self.gen.uniform(0.05, 0.2)
    self.model.geom_pos[self.id_target, 0] = radius * math.sin(angle)
    self.model.geom_pos[self.id_target, 1] = radius * math.cos(angle)

  def _to_target(self) -> np.ndarray:
    return (
      self.data.geom_xpos[self.id_target, :2]
      - self.data.geom_xpos[self.id_finger, :2]
    )

  def task_get_reward(self) -> float:
    radii = float(
      self.model.geom_size[self.id_target, 0]
      + self.model.geom_size[self.id_finger, 0]
    )
    return tolerance(float(np.linalg.norm(self._to_target())), 0, radii)

  def task_observation(self) -> Dict[str, np.ndarray]:
    return {
      "position": np.copy(self.data.qpos),
      "to_target": self._to_target(),
      "velocity": np.copy(self.data.qvel),
    }


class DmcCheetahEnv(DmcEnv):
  """dmc cheetah run (``envpool/mujoco/dmc/cheetah.h``)."""

  name = "DmcCheetah"
  model_xml = assets.CHEETAH_XML
  _RUN_SPEED = 10.0

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"frame_skip": 1, "task_name": "run"}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {
      "obs:position": ArraySpec(np.float64, (8,)),
      "obs:velocity": ArraySpec(np.float64, (9,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float64, (-1, 6), -1.0, 1.0)}

  def __init__(self, cfg: Any, env_id: int) -> None:
    super().__init__(cfg, env_id)
    if self.task_name != "run":
      raise RuntimeError(
        f"Unknown task_name {self.task_name} for dmc cheetah."
      )
    self.id_speed = self.sensor_id("torso_subtreelinvel")

  def task_initialize_episode(self) -> None:
    # cheetah.h:86-100: randomize limited joints, then settle 200 steps
    for j in range(self.model.njnt):
      if self.model.jnt_limited[j]:
        lo, hi = self.model.jnt_range[j]
        self.data.qpos[self.model.jnt_qposadr[j]] = self.gen.uniform(lo, hi)
    self.physics_step(200)
    self.data.time = 0.0

  def task_get_reward(self) -> float:
    speed = float(self.data.sensordata[self.id_speed])
    return tolerance(
      speed, self._RUN_SPEED, _INF, self._RUN_SPEED, 0, LINEAR
    )

  def task_observation(self) -> Dict[str, np.ndarray]:
    return {
      "position": np.copy(self.data.qpos[1:]),
      "velocity": np.copy(self.data.qvel),
    }


class DmcAcrobotEnv(DmcEnv):
  """dmc acrobot swingup(_sparse) (``envpool/mujoco/dmc/acrobot.h``)."""

  name = "DmcAcrobot"
  model_xml = assets.ACROBOT_XML

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"frame_skip": 1, "task_name": "swingup"}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {
      "obs:orientations": ArraySpec(np.float64, (4,)),
      "obs:velocity": ArraySpec(np.float64, (2,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float64, (-1, 1), -1.0, 1.0)}

  def __init__(self, cfg: Any, env_id: int) -> None:
    super().__init__(cfg, env_id)
    if self.task_name not in ("swingup", "swingup_sparse"):
      raise RuntimeError(
        f"Unknown task_name {self.task_name} for dmc acrobot."
      )
    self.is_sparse = self.task_name == "swingup_sparse"
    self.id_upper = self.body_id("upper_arm")
    self.id_lower = self.body_id("lower_arm")
    mujoco = self._mujoco
    self.id_target = mujoco.mj_name2id(
      self.model, mujoco.mjtObj.mjOBJ_SITE, "target"
    )
    self.id_tip = mujoco.mj_name2id(
      self.model, mujoco.mjtObj.mjOBJ_SITE, "tip"
    )
    self.id_shoulder = self.qpos_id("shoulder")
    self.id_elbow = self.qpos_id("elbow")

  def task_initialize_episode(self) -> None:
    self.data.qpos[self.id_shoulder] = self.gen.uniform(-math.pi, math.pi)
    self.data.qpos[self.id_elbow] = self.gen.uniform(-math.pi, math.pi)

  def task_get_reward(self) -> float:
    target_radius = float(self.model.site_size[self.id_target, 0])
    d = np.linalg.norm(
      self.data.site_xpos[self.id_target] - self.data.site_xpos[self.id_tip]
    )
    return tolerance(
      float(d), 0.0, target_radius, 0.0 if self.is_sparse else 1.0
    )

  def task_observation(self) -> Dict[str, np.ndarray]:
    xu = self.data.xmat[self.id_upper].reshape(3, 3)
    xl = self.data.xmat[self.id_lower].reshape(3, 3)
    return {
      "orientations": np.asarray(
        [xu[0, 2], xl[0, 2], xu[2, 2], xl[2, 2]]
      ),
      "velocity": np.copy(self.data.qvel),
    }


class DmcBallInCupEnv(DmcEnv):
  """dmc ball_in_cup catch (``envpool/mujoco/dmc/ball_in_cup.h``)."""

  name = "DmcBallInCup"
  model_xml = assets.BALL_IN_CUP_XML

  @staticmethod
  def default_config() -> Dict[str, Any]:
    # ball_in_cup.h:42 binds frame_skip 10 (the suite's 0.02s control
    # timestep over the 0.002s physics step)
    return {"frame_skip": 10, "task_name": "catch"}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {
      "obs:position": ArraySpec(np.float64, (4,)),
      "obs:velocity": ArraySpec(np.float64, (4,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float64, (-1, 2), -1.0, 1.0)}

  def __init__(self, cfg: Any, env_id: int) -> None:
    super().__init__(cfg, env_id)
    if self.task_name != "catch":
      raise RuntimeError(
        f"Unknown task_name {self.task_name} for dmc ball_in_cup."
      )
    mujoco = self._mujoco
    self.id_target = mujoco.mj_name2id(
      self.model, mujoco.mjtObj.mjOBJ_SITE, "target"
    )
    self.id_ball = self.body_id("ball")
    self.id_ball_geom = self.geom_id("ball")
    self.id_ball_x = self.qpos_id("ball_x")
    self.id_ball_z = self.qpos_id("ball_z")

  def task_initialize_episode(self) -> None:
    # rejection sample a collision-free drop position (ball_in_cup.h:86-97)
    for _ in range(1000):
      self.data.qpos[self.id_ball_x] = self.gen.uniform(-0.2, 0.2)
      self.data.qpos[self.id_ball_z] = self.gen.uniform(0.2, 0.5)
      self._forward_no_actuation()
      if self.data.ncon <= 0:
        break

  def _in_target(self) -> bool:
    # reward window shrinks by the ball radius (ball_in_cup.h:142-152)
    target = self.data.site_xpos[self.id_target][[0, 2]]
    ball = self.data.xpos[self.id_ball][[0, 2]]
    size = self.model.site_size[self.id_target][[0, 2]]
    ball_size = self.model.geom_size[self.id_ball_geom, 0]
    d = np.abs(target - ball)
    return bool(np.all(d < size - ball_size))

  def task_get_reward(self) -> float:
    return 1.0 if self._in_target() else 0.0

  def task_observation(self) -> Dict[str, np.ndarray]:
    return {
      "position": np.copy(self.data.qpos),
      "velocity": np.copy(self.data.qvel),
    }


class DmcHopperEnv(DmcEnv):
  """dmc hopper stand/hop (``envpool/mujoco/dmc/hopper.h``)."""

  name = "DmcHopper"
  model_xml = assets.DMC_HOPPER_XML
  _STAND_HEIGHT = 0.6
  _HOP_SPEED = 2.0

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"frame_skip": 4, "task_name": "stand"}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {
      "obs:position": ArraySpec(np.float64, (6,)),
      "obs:velocity": ArraySpec(np.float64, (7,)),
      "obs:touch": ArraySpec(np.float64, (2,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float64, (-1, 4), -1.0, 1.0)}

  def __init__(self, cfg: Any, env_id: int) -> None:
    super().__init__(cfg, env_id)
    if self.task_name not in ("stand", "hop"):
      raise RuntimeError(
        f"Unknown task_name {self.task_name} for dmc hopper."
      )
    self.hopping = self.task_name == "hop"
    self.id_torso = self.body_id("torso")
    self.id_foot = self.body_id("foot")
    self.id_speed = self.sensor_id("torso_subtreelinvel")
    self.id_toe = self.sensor_id("touch_toe")
    self.id_heel = self.sensor_id("touch_heel")

  def task_initialize_episode(self) -> None:
    self.randomize_limited_and_rotational_joints()

  def _height(self) -> float:
    return float(
      self.data.xipos[self.id_torso, 2] - self.data.xipos[self.id_foot, 2]
    )

  def task_get_reward(self) -> float:
    standing = tolerance(self._height(), self._STAND_HEIGHT, 2.0)
    if self.hopping:
      hop = tolerance(
        float(self.data.sensordata[self.id_speed]),
        self._HOP_SPEED, _INF, self._HOP_SPEED / 2, 0.5, LINEAR,
      )
      return float(standing * hop)
    small_control = float(np.mean([
      tolerance(c, 0.0, 0.0, 1.0, 0.0, QUADRATIC) for c in self.data.ctrl
    ]))
    small_control = (small_control + 4) / 5
    return float(standing * small_control)

  def task_observation(self) -> Dict[str, np.ndarray]:
    return {
      "position": np.copy(self.data.qpos[1:]),
      "velocity": np.copy(self.data.qvel),
      "touch": np.log1p(np.asarray([
        self.data.sensordata[self.id_toe],
        self.data.sensordata[self.id_heel],
      ])),
    }


class DmcWalkerEnv(DmcEnv):
  """dmc walker stand/walk/run (``envpool/mujoco/dmc/walker.h``)."""

  name = "DmcWalker"
  model_xml = assets.DMC_WALKER_XML
  _STAND_HEIGHT = 1.2
  _SPEEDS = {"stand": 0.0, "walk": 1.0, "run": 8.0}

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"frame_skip": 10, "task_name": "stand"}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {
      "obs:orientations": ArraySpec(np.float64, (14,)),
      "obs:height": ArraySpec(np.float64, (-1,)),
      "obs:velocity": ArraySpec(np.float64, (9,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float64, (-1, 6), -1.0, 1.0)}

  def __init__(self, cfg: Any, env_id: int) -> None:
    super().__init__(cfg, env_id)
    if self.task_name not in self._SPEEDS:
      raise RuntimeError(
        f"Unknown task_name {self.task_name} for dmc walker."
      )
    self.move_speed = self._SPEEDS[self.task_name]
    self.id_torso = self.body_id("torso")
    self.id_speed = self.sensor_id("torso_subtreelinvel")

  def task_initialize_episode(self) -> None:
    self.randomize_limited_and_rotational_joints()

  def task_get_reward(self) -> float:
    height = float(self.data.xpos[self.id_torso, 2])
    upright = (1 + self.data.xmat[self.id_torso].reshape(3, 3)[2, 2]) / 2
    standing = tolerance(
      height, self._STAND_HEIGHT, _INF, self._STAND_HEIGHT / 2
    )
    stand_reward = (3 * standing + upright) / 4
    if self.move_speed == 0:
      return float(stand_reward)
    move = tolerance(
      float(self.data.sensordata[self.id_speed]),
      self.move_speed, _INF, self.move_speed / 2, 0.5, LINEAR,
    )
    return float(stand_reward * (5 * move + 1) / 6)

  def task_observation(self) -> Dict[str, np.ndarray]:
    orient = []
    for i in range(1, 8):
      xmat = self.data.xmat[i].reshape(3, 3)
      orient += [xmat[0, 0], xmat[0, 2]]
    return {
      "orientations": np.asarray(orient),
      "height": np.float64(self.data.xpos[self.id_torso, 2]),
      "velocity": np.copy(self.data.qvel),
    }


class DmcFingerEnv(DmcEnv):
  """dmc finger spin/turn_easy/turn_hard (``envpool/mujoco/dmc/finger.h``)."""

  name = "DmcFinger"
  model_xml = assets.FINGER_XML
  _EASY_TARGET = 0.07
  _HARD_TARGET = 0.03
  _SPIN_VELOCITY = 15.0

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"frame_skip": 2, "task_name": "spin"}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {
      "obs:position": ArraySpec(np.float64, (4,)),
      "obs:velocity": ArraySpec(np.float64, (3,)),
      "obs:touch": ArraySpec(np.float64, (2,)),
      "obs:target_position": ArraySpec(np.float64, (2,)),
      "obs:dist_to_target": ArraySpec(np.float64, ()),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float64, (-1, 2), -1.0, 1.0)}

  def __init__(self, cfg: Any, env_id: int) -> None:
    super().__init__(cfg, env_id)
    if self.task_name not in ("spin", "turn_easy", "turn_hard"):
      raise RuntimeError(
        f"Unknown task_name {self.task_name} for dmc finger."
      )
    self.is_spin = self.task_name == "spin"
    self.target_radius = (
      self._EASY_TARGET if self.task_name == "turn_easy"
      else self._HARD_TARGET
    )
    mujoco = self._mujoco
    self.id_site_target = mujoco.mj_name2id(
      self.model, mujoco.mjtObj.mjOBJ_SITE, "target"
    )
    self.id_hinge_joint = mujoco.mj_name2id(
      self.model, mujoco.mjtObj.mjOBJ_JOINT, "hinge"
    )
    self.id_hinge_dof = self.qvel_id("hinge")
    self.id_cap1 = self.geom_id("cap1")
    for s in (
      "proximal", "distal", "proximal_velocity", "distal_velocity",
      "hinge_velocity", "tip", "target", "spinner", "touchtop",
      "touchbottom",
    ):
      setattr(self, f"s_{s}", self.sensor_id(s))

  def task_initialize_episode(self) -> None:
    # finger.h:118-141
    if self.is_spin:
      self.model.dof_damping[self.id_hinge_dof] = 0.03
    else:
      target_angle = self.gen.uniform(-math.pi, math.pi)
      hinge_x = self.data.xanchor[self.id_hinge_dof, 0]
      hinge_z = self.data.xanchor[self.id_hinge_dof, 2]
      radius = float(np.sum(self.model.geom_size[self.id_cap1]))
      self.model.site_pos[self.id_site_target, 0] = (
        hinge_x + radius * math.sin(target_angle)
      )
      self.model.site_pos[self.id_site_target, 2] = (
        hinge_z + radius * math.cos(target_angle)
      )
      self.model.site_size[self.id_site_target, 0] = self.target_radius
    # collision-free random joint angles (finger.h:196-213)
    for _ in range(1000):
      self.randomize_limited_and_rotational_joints()
      self._forward_no_actuation()
      if self.data.ncon == 0:
        break

  def _tip_position(self) -> np.ndarray:
    sd = self.data.sensordata
    return np.asarray([
      sd[self.s_tip + 0] - sd[self.s_spinner + 0],
      sd[self.s_tip + 2] - sd[self.s_spinner + 2],
    ])

  def _target_position(self) -> np.ndarray:
    sd = self.data.sensordata
    return np.asarray([
      sd[self.s_target + 0] - sd[self.s_spinner + 0],
      sd[self.s_target + 2] - sd[self.s_spinner + 2],
    ])

  def _dist_to_target(self) -> float:
    d = self._target_position() - self._tip_position()
    return float(
      np.linalg.norm(d) - self.model.site_size[self.id_site_target, 0]
    )

  def task_get_reward(self) -> float:
    if self.is_spin:
      return float(
        self.data.sensordata[self.s_hinge_velocity] <= -self._SPIN_VELOCITY
      )
    return float(self._dist_to_target() <= 0)

  def task_observation(self) -> Dict[str, np.ndarray]:
    sd = self.data.sensordata
    tip = self._tip_position()
    if self.is_spin:
      # the reference writes target_position/dist_to_target only for
      # turn tasks; spin leaves the zero-filled slots (finger.h:187-195)
      target = np.zeros(2)
      dist = np.float64(0.0)
    else:
      target = self._target_position()
      dist = np.float64(self._dist_to_target())
    return {
      "position": np.asarray(
        [sd[self.s_proximal], sd[self.s_distal], tip[0], tip[1]]
      ),
      "velocity": np.asarray([
        sd[self.s_proximal_velocity], sd[self.s_distal_velocity],
        sd[self.s_hinge_velocity],
      ]),
      "touch": np.log1p(
        np.asarray([sd[self.s_touchtop], sd[self.s_touchbottom]])
      ),
      "target_position": target,
      "dist_to_target": dist,
    }


class DmcSwimmerEnv(DmcEnv):
  """dmc swimmer swimmer6/swimmer15 (``envpool/mujoco/dmc/swimmer.h``)."""

  name = "DmcSwimmer"
  model_xml = staticmethod(assets.swimmer_xml)

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"frame_skip": 15, "task_name": "swimmer6"}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    task = str(cfg.task_name)
    n = {"swimmer6": 6, "swimmer15": 15}.get(task)
    if n is None:
      raise RuntimeError(f"Unknown task_name {task} for dmc swimmer.")
    return {
      "obs:joints": ArraySpec(np.float64, (n - 1,)),
      "obs:to_target": ArraySpec(np.float64, (2,)),
      "obs:body_velocities": ArraySpec(np.float64, (3 * n,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    n = {"swimmer6": 6, "swimmer15": 15}.get(str(cfg.task_name), 6)
    return {"action": ArraySpec(np.float64, (-1, n - 1), -1.0, 1.0)}

  def __init__(self, cfg: Any, env_id: int) -> None:
    super().__init__(cfg, env_id)
    self.n_bodies = {"swimmer6": 6, "swimmer15": 15}[self.task_name]
    mujoco = self._mujoco
    self.id_nose = self.geom_id("nose")
    self.id_head_body = self.body_id("head")
    self.id_target = self.geom_id("target")
    self.id_light = mujoco.mj_name2id(
      self.model, mujoco.mjtObj.mjOBJ_LIGHT, "target_light"
    )
    self.vel_sensors = [self.sensor_id("velocimeter_head")] + [
      self.sensor_id(f"velocimeter_{i}") for i in range(self.n_bodies - 1)
    ]
    self.gyro_sensors = [self.sensor_id("gyro_head")] + [
      self.sensor_id(f"gyro_{i}") for i in range(self.n_bodies - 1)
    ]

  def task_initialize_episode(self) -> None:
    # swimmer.h: target in a 2x2 box (or 0.3 close-in with prob 0.2)
    self.randomize_limited_and_rotational_joints()
    target_box = 0.3 if self.gen.uniform(0, 1) < 0.2 else 2.0
    xpos = self.gen.uniform(-target_box, target_box)
    ypos = self.gen.uniform(-target_box, target_box)
    self.model.geom_pos[self.id_target, 0] = xpos
    self.model.geom_pos[self.id_target, 1] = ypos
    self.model.light_pos[self.id_light, 0] = xpos
    self.model.light_pos[self.id_light, 1] = ypos

  def _nose_to_target(self) -> np.ndarray:
    d = (
      self.data.geom_xpos[self.id_target]
      - self.data.geom_xpos[self.id_nose]
    )
    # dm_control rotates into the HEAD frame via data.xmat['head']; in
    # its asset the "head" geom has identity orientation so swimmer.h's
    # geom_xmat read is the same frame — the replica's head_geom capsule
    # is fromto-rotated, so the body xmat is the faithful choice here.
    xmat = self.data.xmat[self.id_head_body].reshape(3, 3)
    return (xmat.T @ d)[:2]

  def task_get_reward(self) -> float:
    target_size = float(self.model.geom_size[self.id_target, 0])
    d = float(np.linalg.norm(self._nose_to_target()))
    return tolerance(
      d, 0.0, target_size, 5 * target_size, 0.1, LONG_TAIL
    )

  def task_observation(self) -> Dict[str, np.ndarray]:
    sd = self.data.sensordata
    vels = []
    for v, g in zip(self.vel_sensors, self.gyro_sensors):
      vels += [sd[v + 0], sd[v + 1], sd[g + 2]]
    return {
      "joints": np.copy(self.data.qpos[3:]),
      "to_target": self._nose_to_target(),
      "body_velocities": np.asarray(vels),
    }


class DmcFishEnv(DmcEnv):
  """dmc fish upright/swim (``envpool/mujoco/dmc/fish.h``)."""

  name = "DmcFish"
  model_xml = assets.FISH_XML
  _JOINTS = (
    "tail1", "tail_twist", "tail2", "finright_roll", "finright_pitch",
    "finleft_roll", "finleft_pitch",
  )

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"frame_skip": 10, "task_name": "upright"}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {
      "obs:joint_angles": ArraySpec(np.float64, (7,)),
      "obs:upright": ArraySpec(np.float64, ()),
      "obs:velocity": ArraySpec(np.float64, (13,)),
      "obs:target": ArraySpec(np.float64, (3,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float64, (-1, 5), -1.0, 1.0)}

  def __init__(self, cfg: Any, env_id: int) -> None:
    super().__init__(cfg, env_id)
    if self.task_name not in ("upright", "swim"):
      raise RuntimeError(f"Unknown task_name {self.task_name} for dmc fish.")
    self.is_swim = self.task_name == "swim"
    self.id_mouth = self.geom_id("mouth")
    self.id_root = self.qpos_id("root")
    self.id_torso = self.body_id("torso")
    self.id_target = self.geom_id("target")
    self.jq = [self.qpos_id(j) for j in self._JOINTS]
    self.jv = [self.qvel_id(j) for j in self._JOINTS]

  def task_initialize_episode(self) -> None:
    quat = self.gen.normal(0, 1, 4)
    self.data.qpos[self.id_root + 3:self.id_root + 7] = (
      quat / np.linalg.norm(quat)
    )
    for jid in self.jq:
      self.data.qpos[jid] = self.gen.uniform(-0.2, 0.2)
    if self.is_swim:
      self.model.geom_pos[self.id_target, 0] = self.gen.uniform(-0.4, 0.4)
      self.model.geom_pos[self.id_target, 1] = self.gen.uniform(-0.4, 0.4)
      self.model.geom_pos[self.id_target, 2] = self.gen.uniform(0.1, 0.3)
    else:
      self.model.geom_rgba[self.id_target, 3] = 0

  def _upright(self) -> float:
    return float(self.data.xmat[self.id_torso].reshape(3, 3)[2, 2])

  def _mouth_to_target(self) -> np.ndarray:
    d = (
      self.data.geom_xpos[self.id_target]
      - self.data.geom_xpos[self.id_mouth]
    )
    # in torso frame (the dm_control obs convention)
    return self.data.xmat[self.id_torso].reshape(3, 3).T @ d

  def task_get_reward(self) -> float:
    if not self.is_swim:
      return tolerance(self._upright(), 1.0, 1.0, 1.0)
    radii = float(
      self.model.geom_size[self.id_mouth, 0]
      + self.model.geom_size[self.id_target, 0]
    )
    d = float(np.linalg.norm(self._mouth_to_target()))
    in_target = tolerance(d, 0.0, radii, 2 * radii)
    is_upright = 0.5 * (self._upright() + 1)
    return float((7 * in_target + is_upright) / 8)

  def task_observation(self) -> Dict[str, np.ndarray]:
    return {
      "joint_angles": np.asarray([self.data.qpos[j] for j in self.jq]),
      "upright": np.float64(self._upright()),
      "velocity": np.copy(self.data.qvel),
      "target": (
        self._mouth_to_target() if self.is_swim else np.zeros(3)
      ),
    }


class DmcHumanoidEnv(DmcEnv):
  """dmc humanoid stand/walk/run/run_pure_state
  (``envpool/mujoco/dmc/humanoid.h``)."""

  name = "DmcHumanoid"
  model_xml = assets.DMC_HUMANOID_XML
  _STAND_HEIGHT = 1.4
  _SPEEDS = {
    "stand": 0.0, "walk": 1.0, "run": 10.0, "run_pure_state": 10.0,
  }

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"frame_skip": 5, "task_name": "stand"}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {
      "obs:joint_angles": ArraySpec(np.float64, (21,)),
      "obs:head_height": ArraySpec(np.float64, ()),
      "obs:extremities": ArraySpec(np.float64, (12,)),
      "obs:torso_vertical": ArraySpec(np.float64, (3,)),
      "obs:com_velocity": ArraySpec(np.float64, (3,)),
      "obs:position": ArraySpec(np.float64, (28,)),
      "obs:velocity": ArraySpec(np.float64, (27,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float64, (-1, 21), -1.0, 1.0)}

  def __init__(self, cfg: Any, env_id: int) -> None:
    super().__init__(cfg, env_id)
    if self.task_name not in self._SPEEDS:
      raise RuntimeError(
        f"Unknown task_name {self.task_name} for dmc humanoid."
      )
    self.move_speed = self._SPEEDS[self.task_name]
    self.is_pure_state = self.task_name == "run_pure_state"
    self.id_head = self.body_id("head")
    self.id_torso = self.body_id("torso")
    self.id_ext = [
      self.body_id(b)
      for b in ("left_hand", "left_foot", "right_hand", "right_foot")
    ]
    self.id_speed = self.sensor_id("torso_subtreelinvel")

  def task_initialize_episode(self) -> None:
    # collision-free random joint state (humanoid.h:98-110)
    for _ in range(100):
      self.randomize_limited_and_rotational_joints()
      self._forward_no_actuation()
      if self.data.ncon <= 0:
        break

  def _com_velocity(self) -> np.ndarray:
    s = self.id_speed
    return np.copy(self.data.sensordata[s:s + 3])

  def task_get_reward(self) -> float:
    head = float(self.data.xpos[self.id_head, 2])
    standing = tolerance(
      head, self._STAND_HEIGHT, _INF, self._STAND_HEIGHT / 4
    )
    upright_v = float(self.data.xmat[self.id_torso].reshape(3, 3)[2, 2])
    upright = tolerance(upright_v, 0.9, _INF, 1.9, 0.0, LINEAR)
    stand_reward = standing * upright
    small_control = float(np.mean([
      tolerance(c, 0.0, 0.0, 1.0, 0.0, QUADRATIC) for c in self.data.ctrl
    ]))
    small_control = (small_control + 4.0) / 5.0
    comv = self._com_velocity()
    if self.move_speed == 0:
      dont_move = sum(
        0.5 * tolerance(float(v), 0.0, 0.0, 2.0) for v in comv[:2]
      )
      return float(small_control * stand_reward * dont_move)
    speed = float(np.hypot(comv[0], comv[1]))
    move = tolerance(
      speed, self.move_speed, _INF, self.move_speed, 0.0, LINEAR
    )
    move = (5.0 * move + 1.0) / 6.0
    return float(small_control * stand_reward * move)

  def task_observation(self) -> Dict[str, np.ndarray]:
    torso_frame = self.data.xmat[self.id_torso].reshape(3, 3)
    torso_pos = self.data.xpos[self.id_torso]
    ext = []
    for b in self.id_ext:
      ext += list((self.data.xpos[b] - torso_pos) @ torso_frame)
    obs = {
      "joint_angles": np.copy(self.data.qpos[7:]),
      "head_height": np.float64(self.data.xpos[self.id_head, 2]),
      "extremities": np.asarray(ext),
      "torso_vertical": np.copy(torso_frame[2]),
      "com_velocity": self._com_velocity(),
      "position": np.copy(self.data.qpos),
      "velocity": np.copy(self.data.qvel),
    }
    if self.is_pure_state:
      # pure-state tasks expose position/velocity; the pixels-era fields
      # are zeroed (the reference simply omits them from the dict; our
      # static specs keep every key)
      obs["joint_angles"] = np.zeros(21)
      obs["head_height"] = np.float64(0.0)
      obs["extremities"] = np.zeros(12)
      obs["torso_vertical"] = np.zeros(3)
      obs["com_velocity"] = np.zeros(3)
    else:
      obs["position"] = np.zeros(28)
    return obs



class DmcHumanoidCMUEnv(DmcEnv):
  """dmc humanoid_CMU stand/run (``envpool/mujoco/dmc/humanoid_CMU.h``).

  56-DOF CMU-mocap skeleton (``assets.humanoid_cmu_xml``); reward is the
  humanoid recipe on the thorax/head bodies: standing (head above 1.4) x
  linear-upright (thorax z-y) x small-control, times dont_move (stand) or
  the (5*move+1)/6 com-speed term (run, target 10 m/s)."""

  name = "DmcHumanoidCMU"
  model_xml = assets.humanoid_cmu_xml()
  _STAND_HEIGHT = 1.4
  _SPEEDS = {"stand": 0.0, "run": 10.0}

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"frame_skip": 10, "task_name": "stand"}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {
      "obs:joint_angles": ArraySpec(np.float64, (56,)),
      "obs:head_height": ArraySpec(np.float64, ()),
      "obs:extremities": ArraySpec(np.float64, (12,)),
      "obs:torso_vertical": ArraySpec(np.float64, (3,)),
      "obs:com_velocity": ArraySpec(np.float64, (3,)),
      "obs:velocity": ArraySpec(np.float64, (62,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float64, (-1, 56), -1.0, 1.0)}

  def __init__(self, cfg: Any, env_id: int) -> None:
    super().__init__(cfg, env_id)
    if self.task_name not in self._SPEEDS:
      raise RuntimeError(
        f"Unknown task_name {self.task_name} for dmc humanoid_CMU."
      )
    self.move_speed = self._SPEEDS[self.task_name]
    self.id_head = self.body_id("head")
    self.id_thorax = self.body_id("thorax")
    self.id_ext = [
      self.body_id(b) for b in ("lhand", "lfoot", "rhand", "rfoot")
    ]
    self.id_speed = self.sensor_id("thorax_subtreelinvel")

  def task_initialize_episode(self) -> None:
    # collision-free random configuration (humanoid_CMU.h:110-123)
    for _ in range(100):
      self.randomize_limited_and_rotational_joints()
      self._forward_no_actuation()
      if self.data.ncon <= 0:
        break

  def _com_velocity(self) -> np.ndarray:
    s = self.id_speed
    return np.copy(self.data.sensordata[s:s + 3])

  def task_get_reward(self) -> float:
    head = float(self.data.xpos[self.id_head, 2])
    standing = tolerance(
      head, self._STAND_HEIGHT, _INF, self._STAND_HEIGHT / 4
    )
    # thorax 'zy' component (humanoid_CMU.h:199-202)
    upright_v = float(self.data.xmat[self.id_thorax].reshape(3, 3)[2, 1])
    upright = tolerance(upright_v, 0.9, _INF, 1.9, 0.0, LINEAR)
    stand_reward = standing * upright
    small_control = float(np.mean([
      tolerance(c, 0.0, 0.0, 1.0, 0.0, QUADRATIC) for c in self.data.ctrl
    ]))
    small_control = (small_control + 4.0) / 5.0
    comv = self._com_velocity()
    if self.move_speed == 0:
      dont_move = sum(
        0.5 * tolerance(float(v), 0.0, 0.0, 2.0) for v in comv[:2]
      )
      return float(small_control * stand_reward * dont_move)
    speed = float(np.hypot(comv[0], comv[1]))
    move = tolerance(
      speed, self.move_speed, _INF, self.move_speed, 0.0, LINEAR
    )
    move = (5.0 * move + 1.0) / 6.0
    return float(small_control * stand_reward * move)

  def task_observation(self) -> Dict[str, np.ndarray]:
    torso_frame = self.data.xmat[self.id_thorax].reshape(3, 3)
    torso_pos = self.data.xpos[self.id_thorax]
    ext = []
    for b in self.id_ext:
      ext += list((self.data.xpos[b] - torso_pos) @ torso_frame)
    return {
      "joint_angles": np.copy(self.data.qpos[7:]),
      "head_height": np.float64(self.data.xpos[self.id_head, 2]),
      "extremities": np.asarray(ext),
      "torso_vertical": np.copy(torso_frame[2]),
      "com_velocity": self._com_velocity(),
      "velocity": np.copy(self.data.qvel),
    }


class DmcManipulatorEnv(DmcEnv):
  """dmc manipulator bring/insert ball/peg
  (``envpool/mujoco/dmc/manipulator.h``)."""

  name = "DmcManipulator"
  model_xml = staticmethod(assets.manipulator_xml)
  _CLOSE = 0.01
  _P_IN_HAND = 0.1
  _P_IN_TARGET = 0.1
  _ARM_JOINTS = (
    "arm_root", "arm_shoulder", "arm_elbow", "arm_wrist",
    "finger", "fingertip", "thumb", "thumbtip",
  )
  _TOUCH = (
    "palm_touch", "finger_touch", "thumb_touch", "fingertip_touch",
    "thumbtip_touch",
  )

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"frame_skip": 10, "task_name": "bring_ball"}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {
      "obs:arm_pos": ArraySpec(np.float64, (8, 2)),
      "obs:arm_vel": ArraySpec(np.float64, (8,)),
      "obs:touch": ArraySpec(np.float64, (5,)),
      "obs:hand_pos": ArraySpec(np.float64, (4,)),
      "obs:object_pos": ArraySpec(np.float64, (4,)),
      "obs:object_vel": ArraySpec(np.float64, (3,)),
      "obs:target_pos": ArraySpec(np.float64, (4,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float64, (-1, 5), -1.0, 1.0)}

  def __init__(self, cfg: Any, env_id: int) -> None:
    super().__init__(cfg, env_id)
    t = self.task_name
    if t not in ("bring_ball", "bring_peg", "insert_ball", "insert_peg"):
      raise RuntimeError(f"Unknown task_name {t} for dmc manipulator.")
    self.use_peg = t in ("bring_peg", "insert_peg")
    self.insert = t in ("insert_ball", "insert_peg")
    mj = self._mujoco
    obj = "peg" if self.use_peg else "ball"
    self.id_arm_joints = [
      mj.mj_name2id(self.model, mj.mjtObj.mjOBJ_JOINT, j)
      for j in self._ARM_JOINTS
    ]
    self.id_arm_qpos = [self.qpos_id(j) for j in self._ARM_JOINTS]
    self.id_arm_qvel = [self.qvel_id(j) for j in self._ARM_JOINTS]
    self.id_finger = self.qpos_id("finger")
    self.id_thumb = self.qpos_id("thumb")
    if self.insert:
      self.id_receptacle = mj.mj_name2id(
        self.model, mj.mjtObj.mjOBJ_BODY, "slot" if self.use_peg else "cup"
      )
    self.id_body_target = mj.mj_name2id(
      self.model, mj.mjtObj.mjOBJ_BODY, f"target_{obj}"
    )
    self.id_hand = self.body_id("hand")
    self.id_object = self.body_id(obj)
    self.id_target = self.body_id(f"target_{obj}")
    self.id_obj_qpos = [self.qpos_id(f"{obj}_{a}") for a in "xzy"]
    self.id_obj_qvel = [self.qvel_id(f"{obj}_{a}") for a in "xzy"]
    self.id_touch = [self.sensor_id(s) for s in self._TOUCH]

    def site(name):
      return mj.mj_name2id(self.model, mj.mjtObj.mjOBJ_SITE, name)

    self.id_site_grasp = site("grasp")
    self.id_site_pinch = site("pinch")
    if self.use_peg:
      self.id_site_peg_grasp = site("peg_grasp")
      self.id_site_peg_pinch = site("peg_pinch")
      self.id_site_peg = site("peg")
      self.id_site_target_peg = site("target_peg")
      self.id_site_peg_tip = site("peg_tip")
      self.id_site_target_peg_tip = site("target_peg_tip")
    else:
      self.id_site_ball = site("ball")
      self.id_site_target_ball = site("target_ball")

  def task_initialize_episode(self) -> None:
    # manipulator.h:168-232: randomize arm, place target, put the prop in
    # target / in hand / in the air, reject penetrating states
    import math as _m
    for _ in range(200):
      for i, jid in enumerate(self.id_arm_joints):
        if self.model.jnt_limited[jid]:
          lo, hi = self.model.jnt_range[jid]
        else:
          lo, hi = -_m.pi, _m.pi
        self.data.qpos[self.id_arm_qpos[i]] = self.gen.uniform(lo, hi)
      self.data.qpos[self.id_finger] = self.data.qpos[self.id_thumb]
      target_x = self.gen.uniform(-0.4, 0.4)
      target_z = self.gen.uniform(0.1, 0.4)
      if self.insert:
        target_angle = self.gen.uniform(-_m.pi / 3, _m.pi / 3)
        self.model.body_pos[self.id_receptacle, 0] = target_x
        self.model.body_pos[self.id_receptacle, 2] = target_z
        self.model.body_quat[self.id_receptacle, 0] = _m.cos(
          target_angle / 2
        )
        self.model.body_quat[self.id_receptacle, 2] = _m.sin(
          target_angle / 2
        )
      else:
        target_angle = self.gen.uniform(-_m.pi, _m.pi)
      self.model.body_pos[self.id_body_target, 0] = target_x
      self.model.body_pos[self.id_body_target, 2] = target_z
      self.model.body_quat[self.id_body_target, 0] = _m.cos(target_angle / 2)
      self.model.body_quat[self.id_body_target, 2] = _m.sin(target_angle / 2)

      choice = self.gen.uniform(0, 1)
      if choice <= self._P_IN_TARGET:
        obj_x, obj_z, obj_angle = target_x, target_z, target_angle
      elif choice <= self._P_IN_TARGET + self._P_IN_HAND:
        self._forward_no_actuation()
        sx = self.data.site_xpos[self.id_site_grasp]
        obj_x, obj_z = sx[0], sx[2]
        xmat = self.data.site_xmat[self.id_site_grasp].reshape(3, 3)
        obj_angle = _m.pi - _m.atan2(xmat[2, 0], xmat[0, 0])
      else:
        obj_x = self.gen.uniform(-0.5, 0.5)
        obj_z = self.gen.uniform(0, 0.7)
        obj_angle = self.gen.uniform(0, 2 * _m.pi)
        self.data.qvel[self.id_obj_qvel[0]] = self.gen.uniform(-5, 5)
      self.data.qpos[self.id_obj_qpos[0]] = obj_x
      self.data.qpos[self.id_obj_qpos[1]] = obj_z
      self.data.qpos[self.id_obj_qpos[2]] = obj_angle
      self._forward_no_actuation()
      if self.data.ncon <= 0:
        break

  def _site_distance(self, a: int, b: int) -> float:
    return float(
      np.linalg.norm(self.data.site_xpos[a] - self.data.site_xpos[b])
    )

  def _is_close(self, d: float) -> float:
    return tolerance(d, 0.0, self._CLOSE, self._CLOSE * 2)

  def task_get_reward(self) -> float:
    if self.use_peg:
      grasping = (
        self._is_close(
          self._site_distance(self.id_site_peg_grasp, self.id_site_grasp)
        )
        + self._is_close(
          self._site_distance(self.id_site_peg_pinch, self.id_site_pinch)
        )
      ) / 2
      bringing = (
        self._is_close(
          self._site_distance(self.id_site_peg, self.id_site_target_peg)
        )
        + self._is_close(
          self._site_distance(
            self.id_site_target_peg_tip, self.id_site_peg_tip
          )
        )
      ) / 2
      return float(max(bringing, grasping / 3))
    return float(
      self._is_close(
        self._site_distance(self.id_site_ball, self.id_site_target_ball)
      )
    )

  def _body_2d_pose(self, bid: int) -> np.ndarray:
    return np.asarray([
      self.data.xpos[bid, 0], self.data.xpos[bid, 2],
      self.data.xquat[bid, 0], self.data.xquat[bid, 2],
    ])

  def task_observation(self) -> Dict[str, np.ndarray]:
    q = self.data.qpos
    arm_pos = np.stack([
      [np.sin(q[i]), np.cos(q[i])] for i in self.id_arm_qpos
    ])
    return {
      "arm_pos": arm_pos,
      "arm_vel": np.asarray(
        [self.data.qvel[i] for i in self.id_arm_qvel]
      ),
      "touch": np.log1p(np.asarray(
        [self.data.sensordata[i] for i in self.id_touch]
      )),
      "hand_pos": self._body_2d_pose(self.id_hand),
      "object_pos": self._body_2d_pose(self.id_object),
      "object_vel": np.asarray(
        [self.data.qvel[i] for i in self.id_obj_qvel]
      ),
      "target_pos": self._body_2d_pose(self.id_target),
    }
