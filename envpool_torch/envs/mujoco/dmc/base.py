"""dm_control-suite base env of the port — Task/Physics API over raw
mujoco, the port's copy of ``envpool_tpu/envs/mujoco/dmc/base.py``.

Counterpart of ``envpool/mujoco/dmc/mujoco_env.{h,cc}`` (which mirrors
dm_control's rl/control.py + suite/base.py + mujoco/engine.py):

- ControlReset: TaskInitializeEpisodeMjcf -> PhysicsReset (mj_resetData +
  forward with actuation disabled) -> TaskInitializeEpisode ->
  PhysicsAfterReset (:66-76);
- ControlStep: TaskBeforeStep (set ctrl) -> PhysicsStep (mj_step2, then
  n_sub_steps-1 x mj_step, then mj_step1) -> TaskAfterStep -> reward /
  discount / termination bookkeeping (:79-99, :137-156);
- dm discount semantics: early task termination yields discount 0, the
  time limit yields discount 1 (:88-97);
- RandomizeLimitedAndRotationalJoints (:159-200).

dm_control itself is not a dependency: domain MJCF models live in
``assets.py``; where dm_control ships an artist-grade model our replicas
keep the kinematics/actuation/task-relevant geometry and drop the visuals.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np

from envpool_torch.core.host_pool import HostEnv


class DmcEnv(HostEnv):
  """Base for dm_control-suite domains on the host tier."""

  #: MJCF string for the domain; may be a callable(task_name) -> str
  model_xml: Any = ""

  def __init__(self, cfg: Any, env_id: int) -> None:
    super().__init__(cfg, env_id)
    import mujoco
    self._mujoco = mujoco
    xml = self.model_xml
    if callable(xml):
      xml = xml(str(cfg.task_name))
    self.model = mujoco.MjModel.from_xml_string(xml)
    self.data = mujoco.MjData(self.model)
    self.n_sub_steps = int(cfg.frame_skip)
    self.task_name = str(cfg.task_name)
    self.discount = 1.0
    self.reward = 0.0

  # ------------------------------------------------------------ physics layer

  def physics_reset(self) -> None:
    self._mujoco.mj_resetData(self.model, self.data)
    self._forward_no_actuation()

  def _forward_no_actuation(self) -> None:
    old = self.model.opt.disableflags
    self.model.opt.disableflags = (
      old | self._mujoco.mjtDisableBit.mjDSBL_ACTUATION
    )
    try:
      self._mujoco.mj_forward(self.model, self.data)
    finally:
      self.model.opt.disableflags = old

  def physics_step(self, nstep: int) -> None:
    mujoco = self._mujoco
    if self.model.opt.integrator != mujoco.mjtIntegrator.mjINT_RK4:
      mujoco.mj_step2(self.model, self.data)
    else:
      mujoco.mj_step(self.model, self.data)
    for _ in range(nstep - 1):
      mujoco.mj_step(self.model, self.data)
    mujoco.mj_step1(self.model, self.data)

  # -------------------------------------------------------------- task hooks

  def task_initialize_episode_mjcf(self) -> None:
    pass

  def task_initialize_episode(self) -> None:
    pass

  def task_before_step(self, action: np.ndarray) -> None:
    self.data.ctrl[:] = action

  def task_after_step(self) -> None:
    pass

  def task_get_reward(self) -> float:
    raise NotImplementedError

  def task_get_discount(self) -> float:
    return 1.0

  def task_should_terminate_episode(self) -> bool:
    return False

  def task_observation(self) -> Dict[str, np.ndarray]:
    raise NotImplementedError

  # ----------------------------------------------------------------- control

  def control_reset(self) -> None:
    self.discount = 1.0
    self.reward = 0.0
    self.task_initialize_episode_mjcf()
    self.physics_reset()
    self.task_initialize_episode()
    self._forward_no_actuation()

  def control_step(self, action: np.ndarray) -> Tuple[float, bool]:
    """Returns (reward, early_termination)."""
    self.task_before_step(action)
    self.physics_step(self.n_sub_steps)
    self.task_after_step()
    self.reward = self.task_get_reward()
    if self.task_should_terminate_episode():
      self.discount = 0.0
      return self.reward, True
    self.discount = self.task_get_discount()
    return self.reward, False

  # ------------------------------------------------------------ HostEnv API

  def reset(self):
    self.control_reset()
    obs = self.task_observation()
    return obs, self._info()

  def step(self, action):
    reward, term = self.control_step(np.asarray(action, np.float64))
    obs = self.task_observation()
    info = self._info()
    # dm discount semantics: the pool writes discount = !done; dm_control
    # uses discount 0 only on EARLY termination and 1 at the time limit
    # (mujoco_env.cc:88-97) — override accordingly.
    info["_override"] = {"discount": np.float32(self.discount)}
    return obs, reward, term, info

  def _info(self) -> Dict[str, Any]:
    return {}

  # -------------------------------------------------------------- randomizers

  def randomize_limited_and_rotational_joints(self) -> None:
    m = self.model
    mujoco = self._mujoco
    for j in range(m.njnt):
      jtype = m.jnt_type[j]
      limited = bool(m.jnt_limited[j])
      lo, hi = m.jnt_range[j]
      adr = m.jnt_qposadr[j]
      if limited:
        if jtype in (
          mujoco.mjtJoint.mjJNT_HINGE, mujoco.mjtJoint.mjJNT_SLIDE
        ):
          self.data.qpos[adr] = self.gen.uniform(lo, hi)
        elif jtype == mujoco.mjtJoint.mjJNT_BALL:
          axis = self.gen.normal(0, 1, 3)
          axis /= np.linalg.norm(axis)
          angle = self.gen.uniform(0, hi)
          quat = np.zeros(4)
          mujoco.mju_axisAngle2Quat(quat, axis, angle)
          self.data.qpos[adr:adr + 4] = quat
      elif jtype == mujoco.mjtJoint.mjJNT_HINGE:
        self.data.qpos[adr] = self.gen.uniform(-math.pi, math.pi)
      elif jtype == mujoco.mjtJoint.mjJNT_BALL:
        quat = self.gen.normal(0, 1, 4)
        quat /= np.linalg.norm(quat)
        self.data.qpos[adr:adr + 4] = quat
      elif jtype == mujoco.mjtJoint.mjJNT_FREE:
        quat = self.gen.normal(0, 1, 4)
        quat /= np.linalg.norm(quat)
        self.data.qpos[adr + 3:adr + 7] = quat

  # --------------------------------------------------------------- accessors

  def geom_id(self, name: str) -> int:
    return self._mujoco.mj_name2id(
      self.model, self._mujoco.mjtObj.mjOBJ_GEOM, name
    )

  def body_id(self, name: str) -> int:
    return self._mujoco.mj_name2id(
      self.model, self._mujoco.mjtObj.mjOBJ_XBODY, name
    )

  def qpos_id(self, name: str) -> int:
    j = self._mujoco.mj_name2id(
      self.model, self._mujoco.mjtObj.mjOBJ_JOINT, name
    )
    return int(self.model.jnt_qposadr[j])

  def qvel_id(self, name: str) -> int:
    j = self._mujoco.mj_name2id(
      self.model, self._mujoco.mjtObj.mjOBJ_JOINT, name
    )
    return int(self.model.jnt_dofadr[j])

  def sensor_id(self, name: str) -> int:
    s = self._mujoco.mj_name2id(
      self.model, self._mujoco.mjtObj.mjOBJ_SENSOR, name
    )
    return int(self.model.sensor_adr[s])
