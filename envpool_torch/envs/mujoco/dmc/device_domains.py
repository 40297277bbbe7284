"""On-device dm_control-suite domains (``...Jax-v1``), the port's batched
versions.

Counterpart of ``envpool_tpu/envs/mujoco/dmc/device_domains.py`` for all
15 of its domains: the same class names, ``default_config``, specs, state
keys, key use, observations, rewards and ``discount`` info, written over
``[N, ...]`` tensors on the port's engine (``device_engine.py``,
``device_collision.py``) with the models loaded from the committed data
(``device_model.load_dmc_model``, extracted from the replicas in
``assets.py``). The task semantics are those of
``envpool/mujoco/dmc/<domain>.h``:

- ControlStep = set ctrl -> n_sub_steps x mj_step -> reward
  (``mujoco_env.cc:79-99``); the engine's ``step_smooth`` chain plays the
  substeps and observations are recomputed from (q, v), the equivalent of
  the trailing ``mj_step1`` forward pass;
- episodes never terminate early in these domains, so the reserved
  ``discount`` info key is pinned to 1.0: the time limit truncates with
  dm discount 1, never 0 (``mujoco_env.cc:88-97``);
- episode initialization (RandomizeLimitedAndRotationalJoints and the
  per-domain draws) uses jax.random streams (the port's threefry,
  ``core/prng.py``): identically *distributed* to the host tier's MT19937,
  not bit-identical; point_mass "hard"'s rejection loop for actuator-gain
  directions is replaced by an exact draw on the acceptance region
  (loop-free); the collision-free redraws of finger, ball_in_cup,
  manipulator and the humanoids are a static set of ``_INIT_DRAWS``
  candidates (the first collision-free one, else the least penetrating),
  evaluated in one batched pass.

The JAX package writes one env and ``vmap``s it, calling forward
kinematics once per readout; here a step computes it once for its
observation and reward, which read the same values.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Sequence

import numpy as np
import torch

from envpool_torch.core import prng
from envpool_torch.core.env import FuncEnv
from envpool_torch.core.spec import ArraySpec

from .. import device_collision as dc
from .. import device_engine as de
from ..device_model import DeviceModel, load_dmc_model
from .device_rewards import tolerance
from .rewards import LINEAR, LONG_TAIL, QUADRATIC

_INF = float("inf")
_FREE, _SLIDE, _HINGE = 0, 2, 3  # mjtJoint

Tensor = torch.Tensor


def _norm(x: Tensor) -> Tensor:
  """Euclidean norm over the last axis (``jnp.linalg.norm``'s sum of
  squares)."""
  return torch.sqrt((x * x).sum(-1))


def _fma(a: Tensor, b: float, c: float) -> Tensor:
  """float32 ``a * b + c`` rounded once, with the constants in float32: the
  multiply-add XLA contracts the JAX code's expression into."""
  return prng.fma32(a, float(np.float32(b)), float(np.float32(c)))


def _set(q: Tensor, col: int, value: Tensor) -> Tensor:
  """``q`` with column(s) from ``col`` on replaced (``q.at[..].set``)."""
  q = q.clone()
  if value.ndim == 1:
    q[:, col] = value
  else:
    q[:, col:col + value.shape[1]] = value
  return q


def randomize_limited_and_rotational_joints(
  mdl: DeviceModel, q: Tensor, keys: Tensor, limited_only: bool = False,
) -> Tensor:
  """The suite's joint randomizer (``envpool_tpu/envs/mujoco/dmc/base.py``
  ``:147-176``) over a batch: limited joints uniform in range, unlimited
  hinges uniform(-pi, pi), each from its own split of the lane's key in
  joint order. ``limited_only=True`` reproduces the episode inits that
  randomize *only* limited joints and leave unlimited root joints at 0
  (e.g. cheetah, ``envpool/mujoco/dmc/cheetah.h:83-98``). Unlimited FREE
  roots get a uniform random orientation (a normalised 4-normal draw, the
  suite's free-joint branch, ``base.py:173-176``)."""
  q = q.clone()
  for j, jt in enumerate(mdl.jnt_type):
    qa = mdl.jnt_qadr[j]
    if jt == _FREE:
      if not mdl.jnt_limited[j] and not limited_only:
        keys, sub = prng.split(keys).unbind(-2)
        quat = prng.normal(sub, (4,))
        q[:, qa + 3:qa + 7] = quat / torch.sqrt((quat * quat).sum(-1, keepdim=True))
      continue
    if jt not in (_SLIDE, _HINGE):
      continue
    if mdl.jnt_limited[j]:
      keys, sub = prng.split(keys).unbind(-2)
      lo, hi = float(mdl.jnt_range[j, 0]), float(mdl.jnt_range[j, 1])
      q[:, qa] = prng.uniform(sub, (), lo, hi)
    elif jt == _HINGE and not limited_only:
      keys, sub = prng.split(keys).unbind(-2)
      q[:, qa] = prng.uniform(sub, (), -math.pi, math.pi)
  return q


def _pick_collision_free(mdl: DeviceModel, qc: Tensor, n: int,
                         mut=None) -> Tensor:
  """The index ``[n]`` of each lane's first collision-free init candidate.

  ``qc`` holds ``k`` candidates per lane, ``[n * k, nq]`` lane-major
  (``mut``, where given, their body-pose overrides, ``fk``'s). The host
  reference rejection-samples unboundedly (e.g.
  ``envpool/mujoco/dmc/humanoid.h:98-110``); the device tier draws a static
  ``k`` candidates and takes the first with every gated contact candidate
  separated (ncon == 0). When all ``k`` collide it falls back to the LEAST
  penetrating candidate (the max over candidates of the min gated contact
  distance), not to candidate 0. All candidates go through one forward
  kinematics and narrow-phase pass; both choices are an ``argmax``."""
  xpos, xmat, _, _ = de.fk(mdl, qc, mut)
  _, dist, _, _, _, gate = dc.contact_points(mdl, xpos, xmat)
  oks = ((dist >= 0) | ~gate).all(-1).view(n, -1)
  mindist = torch.where(gate, dist, _INF).amin(-1).view(n, -1)
  return torch.where(oks.any(1), torch.argmax(oks.to(torch.uint8), 1),
                     torch.argmax(mindist, 1))


def _take(cands: Tensor, pick: Tensor) -> Tensor:
  """Each lane's picked candidate of ``cands`` ``[n * k, ...]`` (lane-major)
  -> ``[n, ...]``."""
  c = cands.view(pick.shape[0], -1, *cands.shape[1:])
  idx = pick.view(-1, 1, *([1] * (cands.ndim - 1)))
  return torch.take_along_dim(c, idx, 1)[:, 0]


def _site(mdl: DeviceModel, xpos, xmat, name: str) -> Tensor:
  """World position ``[N, 3]`` of a named site from a kinematics pass."""
  s = mdl.site_name2id[name]
  b = mdl.site_body[s]
  c = de.consts_on(mdl, xpos[0].dtype, xpos[0].device)
  return xpos[b] + de._mv(xmat[b], c["site_pos"][s])


def _geom(mdl: DeviceModel, xpos, xmat, name: str) -> Tensor:
  """World position ``[N, 3]`` of a named geom from a kinematics pass."""
  g = mdl.geom_name2id[name]
  b = mdl.geom_body[g]
  c = de.consts_on(mdl, xpos[0].dtype, xpos[0].device)
  return xpos[b] + de._mv(xmat[b], c["geom_pos"][g])


class DmcDeviceEnv(FuncEnv):
  """Shared scaffolding: state = {q, v}; ControlStep = engine x
  n_sub_steps. ``model_name`` names the committed model variant; a
  callable takes the task name (cartpole's pole counts, swimmer's
  sizes)."""

  model_name: Any = ""

  @classmethod
  def mdl(cls, cfg: Any) -> DeviceModel:
    name = cls.model_name
    if callable(name):
      name = name(str(cfg.task_name))
    return load_dmc_model(name)

  @classmethod
  def _physics(cls, cfg: Any, state, action, tau=None):
    q, v = de.step_smooth(cls.mdl(cfg), state["q"], state["v"], action,
                          nstep=int(cfg.frame_skip), tau=tau)
    return {"q": q, "v": v}

  @classmethod
  def _reset_qv(cls, cfg: Any, keys: Tensor):
    """qpos0 and zero velocities, float32, one row per key."""
    mdl = cls.mdl(cfg)
    n = keys.shape[0]
    q0 = de.consts_on(mdl, torch.float32, keys.device)["init_qpos"]
    return (q0.expand(n, mdl.nq).clone(),
            torch.zeros(n, mdl.nv, dtype=torch.float32, device=keys.device))

  # dm discount: 1 at the time limit, 0 only on early termination; these
  # domains never terminate early (``mujoco_env.cc:88-97``)
  @staticmethod
  def _discount_info(like: Tensor) -> Dict[str, Tensor]:
    return {"discount": torch.ones(like.shape[0], dtype=torch.float32,
                                   device=like.device)}

  @classmethod
  def _done(cls, cfg, state, obs, reward):
    """The step's outputs with termination False and the discount info."""
    return (state, obs, reward, torch.zeros_like(reward, dtype=torch.bool),
            cls._discount_info(reward))


class DmcPendulumJaxEnv(DmcDeviceEnv):
  """dmc pendulum swingup on-device (``envpool/mujoco/dmc/pendulum.h``)."""

  name = "DmcPendulumJax"
  model_name = "pendulum"
  _COS_BOUND = math.cos(8.0 / 180 * math.pi)

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"frame_skip": 1, "task_name": "swingup"}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    if str(cfg.task_name) != "swingup":
      raise RuntimeError(
        f"Unknown task_name {cfg.task_name} for dmc pendulum."
      )
    return {
      "obs:orientation": ArraySpec(np.float32, (2,)),
      "obs:velocity": ArraySpec(np.float32, (1,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float32, (-1, 1), -1.0, 1.0)}

  @classmethod
  def _obs(cls, cfg, state, xmat):
    return {
      "orientation": torch.stack([xmat[:, 2, 2], xmat[:, 0, 2]], 1),
      "velocity": state["v"],
    }

  @classmethod
  def reset(cls, cfg: Any, state: Any, keys: Tensor):
    del state
    q, v = cls._reset_qv(cfg, keys)
    q = _set(q, 0, prng.uniform(keys, (), -math.pi, math.pi))
    state = {"q": q, "v": v}
    xmat = de.body_xmat(cls.mdl(cfg), q, "pole")
    return state, cls._obs(cfg, state, xmat), cls._discount_info(q)

  @classmethod
  def step(cls, cfg: Any, state: Any, action: Any, keys: Tensor):
    del keys
    state = cls._physics(cfg, state, action.to(torch.float32))
    xmat = de.body_xmat(cls.mdl(cfg), state["q"], "pole")
    reward = tolerance(xmat[:, 2, 2], cls._COS_BOUND, 1.0)
    return cls._done(cfg, state, cls._obs(cfg, state, xmat), reward)


_CARTPOLE_MODELS = {"two_poles": "cartpole_two_poles",
                    "three_poles": "cartpole_three_poles"}


class DmcCartpoleJaxEnv(DmcDeviceEnv):
  """dmc cartpole on-device (``envpool/mujoco/dmc/cartpole.h``): balance /
  balance_sparse / swingup / swingup_sparse / two_poles / three_poles.
  The cart-box x pole-capsule candidate pairs of two_poles and three_poles
  run through the real box-capsule narrow phase; they only activate under
  deep multi-pole interpenetration, never reached from suite inits."""

  name = "DmcCartpoleJax"
  model_name = staticmethod(lambda task: _CARTPOLE_MODELS.get(task, "cartpole"))

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
      "obs:position": ArraySpec(np.float32, (1 + 2 * n,)),
      "obs:velocity": ArraySpec(np.float32, (1 + n,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float32, (-1, 1), -1.0, 1.0)}

  @classmethod
  def _pole_cosines(cls, cfg, q):
    """zz and xz entries of every pole body's xmat (bodies 2..nbody)
    ``[N, poles]``."""
    mdl = cls.mdl(cfg)
    _, xmat, _, _ = de.fk(mdl, q)
    poles = torch.stack(xmat[2:], 1)                        # [N, n, 3, 3]
    return poles[:, :, 2, 2], poles[:, :, 0, 2]

  @classmethod
  def _obs(cls, state, zz, xz):
    pos = torch.stack([zz, xz], 2).flatten(1)
    return {
      "position": torch.cat([state["q"][:, :1], pos], 1),
      "velocity": state["v"],
    }

  @classmethod
  def reset(cls, cfg: Any, state: Any, keys: Tensor):
    del state
    mdl = cls.mdl(cfg)
    q, _ = cls._reset_qv(cfg, keys)
    task = str(cfg.task_name)
    kq, kr, kv = prng.split(keys, 3).unbind(-2)
    if task in ("swingup", "swingup_sparse", "two_poles", "three_poles"):
      # cartpole.h:121-129
      q = _set(q, 0, 0.01 * prng.normal(kq, ()))
      q = _set(q, 1, _fma(prng.normal(kr, ()), 0.01, math.pi))
      if mdl.nq > 2:
        krest = prng.split(kr, 1)[:, 0]
        q = _set(q, 2, 0.01 * prng.normal(krest, (mdl.nq - 2,)))
    else:
      # cartpole.h:131-137
      q = _set(q, 0, prng.uniform(kq, (), -0.1, 0.1))
      q = _set(q, 1, prng.uniform(kr, (mdl.nq - 1,), -0.034, 0.034))
    v = 0.01 * prng.normal(kv, (mdl.nv,))
    state = {"q": q, "v": v}
    zz, xz = cls._pole_cosines(cfg, q)
    return state, cls._obs(state, zz, xz), cls._discount_info(q)

  @classmethod
  def step(cls, cfg: Any, state: Any, action: Any, keys: Tensor):
    del keys
    action = action.to(torch.float32)
    state = cls._physics(cfg, state, action)
    task = str(cfg.task_name)
    zz, xz = cls._pole_cosines(cfg, state["q"])
    cart = state["q"][:, 0]
    if task in ("balance_sparse", "swingup_sparse"):
      # cartpole.h:152-160
      cart_in_bounds = tolerance(cart, -0.25, 0.25)
      angle_in_bounds = torch.prod(tolerance(zz, 0.995, 1.0), 1)
      reward = cart_in_bounds * angle_in_bounds
    else:
      # cartpole.h:162-183
      upright = ((zz + 1) / 2).mean(1)
      centered = (1 + tolerance(cart, 0.0, 0.0, 2.0)) / 2
      # mj_fwdActuation clamps data_->ctrl in place, so the reference's
      # small_control (cartpole.h:169) sees the ctrlrange-clamped value
      mdl = cls.mdl(cfg)
      ctrl0 = torch.clamp(action[:, 0], float(mdl.ctrl_range[0, 0]),
                          float(mdl.ctrl_range[0, 1]))
      small_control = (tolerance(ctrl0, 0.0, 0.0, 1.0, 0.0, QUADRATIC) + 4) / 5
      small_velocity = (
        tolerance(state["v"][:, 1:], 0.0, 0.0, 5.0).amin(1) + 1
      ) / 2
      reward = upright * small_control * small_velocity * centered
    return cls._done(cfg, state, cls._obs(state, zz, xz), reward)


class DmcAcrobotJaxEnv(DmcDeviceEnv):
  """dmc acrobot swingup(_sparse) on-device
  (``envpool/mujoco/dmc/acrobot.h``)."""

  name = "DmcAcrobotJax"
  model_name = "acrobot"

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"frame_skip": 1, "task_name": "swingup"}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    if str(cfg.task_name) not in ("swingup", "swingup_sparse"):
      raise RuntimeError(
        f"Unknown task_name {cfg.task_name} for dmc acrobot."
      )
    return {
      "obs:orientations": ArraySpec(np.float32, (4,)),
      "obs:velocity": ArraySpec(np.float32, (2,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float32, (-1, 1), -1.0, 1.0)}

  @classmethod
  def _obs(cls, cfg, state, xmat):
    mdl = cls.mdl(cfg)
    xu = xmat[mdl.body_name2id["upper_arm"]]
    xl = xmat[mdl.body_name2id["lower_arm"]]
    return {
      "orientations": torch.stack(
        [xu[:, 0, 2], xl[:, 0, 2], xu[:, 2, 2], xl[:, 2, 2]], 1),
      "velocity": state["v"],
    }

  @classmethod
  def reset(cls, cfg: Any, state: Any, keys: Tensor):
    del state
    q, v = cls._reset_qv(cfg, keys)
    ks, ke = prng.split(keys).unbind(-2)
    q = torch.stack([prng.uniform(ks, (), -math.pi, math.pi),
                     prng.uniform(ke, (), -math.pi, math.pi)], 1)
    state = {"q": q, "v": v}
    _, xmat, _, _ = de.fk(cls.mdl(cfg), q)
    return state, cls._obs(cfg, state, xmat), cls._discount_info(q)

  @classmethod
  def step(cls, cfg: Any, state: Any, action: Any, keys: Tensor):
    del keys
    state = cls._physics(cfg, state, action.to(torch.float32))
    mdl = cls.mdl(cfg)
    xpos, xmat, _, _ = de.fk(mdl, state["q"])
    target_radius = float(mdl.site_size[mdl.site_name2id["target"], 0])
    d = _norm(_site(mdl, xpos, xmat, "target") - _site(mdl, xpos, xmat, "tip"))
    sparse = str(cfg.task_name) == "swingup_sparse"
    reward = tolerance(d, 0.0, target_radius, 0.0 if sparse else 1.0)
    return cls._done(cfg, state, cls._obs(cfg, state, xmat), reward)


class DmcReacherJaxEnv(DmcDeviceEnv):
  """dmc reacher easy/hard on-device (``envpool/mujoco/dmc/reacher.h``).

  The host tier moves the target *geom* per episode (a model mutation);
  here the target position is env state and ``to_target``/reward read it
  directly: the same observable semantics over a static model."""

  name = "DmcReacherJax"
  model_name = "reacher"
  _BIG_TARGET = 0.05
  _SMALL_TARGET = 0.015

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"frame_skip": 1, "task_name": "easy"}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    if str(cfg.task_name) not in ("easy", "hard"):
      raise RuntimeError(
        f"Unknown task_name {cfg.task_name} for dmc reacher."
      )
    return {
      "obs:position": ArraySpec(np.float32, (2,)),
      "obs:to_target": ArraySpec(np.float32, (2,)),
      "obs:velocity": ArraySpec(np.float32, (2,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float32, (-1, 2), -1.0, 1.0)}

  @classmethod
  def _target_size(cls, cfg) -> float:
    return (
      cls._BIG_TARGET if str(cfg.task_name) == "easy"
      else cls._SMALL_TARGET
    )

  @classmethod
  def _to_target(cls, cfg, state):
    finger = de.geom_xpos(cls.mdl(cfg), state["q"], "finger")
    return state["target"] - finger[:, :2]

  @classmethod
  def _obs(cls, state, to_target):
    return {"position": state["q"], "to_target": to_target,
            "velocity": state["v"]}

  @classmethod
  def reset(cls, cfg: Any, state: Any, keys: Tensor):
    del state
    mdl = cls.mdl(cfg)
    kj, ka, kr = prng.split(keys, 3).unbind(-2)
    q, v = cls._reset_qv(cfg, keys)
    q = randomize_limited_and_rotational_joints(mdl, q, kj)
    # reacher.h:96-101: target at uniform angle, radius U(0.05, 0.2)
    angle = prng.uniform(ka, (), 0.0, 2 * math.pi)
    radius = prng.uniform(kr, (), 0.05, 0.2)
    target = torch.stack([radius * torch.sin(angle),
                          radius * torch.cos(angle)], 1)
    state = {"q": q, "v": v, "target": target}
    return state, cls._obs(state, cls._to_target(cfg, state)), \
      cls._discount_info(q)

  @classmethod
  def step(cls, cfg: Any, state: Any, action: Any, keys: Tensor):
    del keys
    new = cls._physics(cfg, state, action.to(torch.float32))
    state = {**state, **new}
    mdl = cls.mdl(cfg)
    radii = cls._target_size(cfg) + float(
      mdl.geom_size[mdl.geom_name2id["finger"], 0])
    to_target = cls._to_target(cfg, state)
    reward = tolerance(_norm(to_target), 0.0, radii)
    return cls._done(cfg, state, cls._obs(state, to_target), reward)


class DmcPointMassJaxEnv(DmcDeviceEnv):
  """dmc point_mass easy/hard on-device
  (``envpool/mujoco/dmc/point_mass.h``).

  The two motors act through fixed tendons whose joint coefficients form
  a 2x2 mixing matrix W (rows = tendon directions; identity for "easy",
  randomized per episode for "hard" via ``wrap_prm``). W lives in env
  state and the generalized force is ``tau = gear * W^T ctrl``, exactly
  mjModel's fixed-tendon moment arm algebra; the committed model is the
  replica with its tendon transmission stripped."""

  name = "DmcPointMassJax"
  model_name = "point_mass"
  _GEAR = 0.1  # <motor gear> of both tendon actuators

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"frame_skip": 1, "task_name": "easy"}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    if str(cfg.task_name) not in ("easy", "hard"):
      raise RuntimeError(
        f"Unknown task_name {cfg.task_name} for dmc point_mass."
      )
    return {
      "obs:position": ArraySpec(np.float32, (2,)),
      "obs:velocity": ArraySpec(np.float32, (2,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float32, (-1, 2), -1.0, 1.0)}

  @classmethod
  def _obs(cls, state):
    return {"position": state["q"], "velocity": state["v"]}

  @classmethod
  def reset(cls, cfg: Any, state: Any, keys: Tensor):
    del state
    mdl = cls.mdl(cfg)
    kj, k1, k2 = prng.split(keys, 3).unbind(-2)
    q, v = cls._reset_qv(cfg, keys)
    q = randomize_limited_and_rotational_joints(mdl, q, kj)
    if str(cfg.task_name) == "hard":
      # point_mass.h randomize_gains: dir1 uniform on the circle; dir2
      # uniform on {d: |dir1 . d| <= 0.9}. The host rejection loop is an
      # exact draw of the angle offset from the acceptance set
      # [a, pi-a] u [pi+a, 2pi-a], a = acos(0.9).
      a1 = prng.uniform(k1, (), 0.0, 2 * math.pi)
      acc = math.acos(0.9)
      u = prng.uniform(k2, (), 0.0, 1.0)
      width = math.pi - 2 * acc
      delta = torch.where(
        u < 0.5,
        _fma(u * 2.0, width, acc),
        _fma((u - 0.5) * 2.0, width, math.pi + acc),
      )
      a2 = a1 + delta
      wrap = torch.stack([
        torch.stack([torch.cos(a1), torch.sin(a1)], 1),
        torch.stack([torch.cos(a2), torch.sin(a2)], 1),
      ], 1)
    else:
      wrap = torch.eye(2, dtype=torch.float32, device=keys.device).expand(
        keys.shape[0], 2, 2).clone()
    state = {"q": q, "v": v, "wrap": wrap}
    return state, cls._obs(state), cls._discount_info(q)

  @classmethod
  def step(cls, cfg: Any, state: Any, action: Any, keys: Tensor):
    del keys
    ctrl = torch.clamp(action.to(torch.float32), -1.0, 1.0)
    tau = cls._GEAR * de._vm(ctrl, state["wrap"])
    new = cls._physics(cfg, state, None, tau=tau)
    state = {**state, **new}
    mdl = cls.mdl(cfg)
    target_size = float(mdl.geom_size[mdl.geom_name2id["target"], 0])
    xpos, xmat, _, _ = de.fk(mdl, state["q"])
    d = _geom(mdl, xpos, xmat, "target") - _geom(mdl, xpos, xmat, "pointmass")
    near = tolerance(_norm(d), 0.0, target_size, target_size)
    control = (
      tolerance(ctrl[:, 0], 0.0, 0.0, 1.0, 0.0, QUADRATIC)
      + tolerance(ctrl[:, 1], 0.0, 0.0, 1.0, 0.0, QUADRATIC)
    ) / 2
    reward = near * ((control + 4) / 5)
    return cls._done(cfg, state, cls._obs(state), reward)


@functools.lru_cache(maxsize=32)
def _site_bodies(key: de._ByIdentity, sites: tuple, device: torch.device):
  """The named sites' bodies and their ids as a device tensor, made once:
  indexing with a host list would copy it to the device at every step."""
  mdl = key.mdl
  sid = [mdl.site_name2id[s] for s in sites]
  return ([mdl.site_body[s] for s in sid],
          torch.as_tensor(sid, dtype=torch.int64, device=device))


def _site_vel_gyro(mdl: DeviceModel, q: Tensor, v: Tensor,
                   sites: Sequence[str]):
  """Velocimeter and gyro sensor values ``[N, k, 3]`` at named sites (site
  frame == body frame in these replicas): each body's Plucker velocity
  moved to the site point, rotated into the body frame (mj_sensorVel).
  One pass over all sites."""
  xpos, xmat, S, _ = de._kin_ctx(mdl, q)
  vel = de.body_velocities(mdl, v, S)                       # [N, nbody-1, 6]
  c = de.consts_on(mdl, q.dtype, q.device)
  bodies, sid = _site_bodies(de._ByIdentity(mdl), tuple(sites), q.device)
  vb = torch.stack([vel[:, b - 1] for b in bodies], 1)      # [N, k, 6]
  rot = torch.stack([xmat[b] for b in bodies], 1)           # [N, k, 3, 3]
  x = torch.stack([xpos[b] for b in bodies], 1) + de._mv(rot, c["site_pos"][sid])
  w, v0 = vb[..., :3], vb[..., 3:]
  lin = de._vm(v0 + torch.linalg.cross(w, x), rot)
  return lin, de._vm(w, rot)


class DmcSwimmerJaxEnv(DmcDeviceEnv):
  """dmc swimmer swimmer6/swimmer15 on-device
  (``envpool/mujoco/dmc/swimmer.h``): the n-link chain in a viscous fluid
  (the engine's inertia-box medium forces), per-link velocimeter + gyro
  observations, target position in env state."""

  name = "DmcSwimmerJax"
  model_name = staticmethod(lambda task: task)

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"frame_skip": 15, "task_name": "swimmer6"}

  @staticmethod
  def _n(cfg) -> int:
    n = {"swimmer6": 6, "swimmer15": 15}.get(str(cfg.task_name))
    if n is None:
      raise RuntimeError(
        f"Unknown task_name {cfg.task_name} for dmc swimmer."
      )
    return n

  @classmethod
  def state_spec(cls, cfg: Any) -> Dict[str, ArraySpec]:
    n = cls._n(cfg)
    return {
      "obs:joints": ArraySpec(np.float32, (n - 1,)),
      "obs:to_target": ArraySpec(np.float32, (2,)),
      "obs:body_velocities": ArraySpec(np.float32, (3 * n,)),
    }

  @classmethod
  def action_spec(cls, cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float32, (-1, cls._n(cfg) - 1), -1., 1.)}

  @classmethod
  def _to_target(cls, cfg, state):
    mdl = cls.mdl(cfg)
    q = state["q"]
    xpos, xmat, _, _ = de.fk(mdl, q)
    z = float(mdl.geom_pos[mdl.geom_name2id["target"], 2])
    target = torch.cat([state["target"],
                        torch.full_like(state["target"][:, :1], z)], 1)
    nose = _geom(mdl, xpos, xmat, "nose")
    head = xmat[mdl.body_name2id["head"]]
    return de._vm(target - nose, head)[:, :2]

  @classmethod
  def _obs(cls, cfg, state, to_target):
    n = cls._n(cfg)
    sites = ["head_site"] + [f"site_{i}" for i in range(n - 1)]
    lin, gyr = _site_vel_gyro(cls.mdl(cfg), state["q"], state["v"], sites)
    vels = torch.cat([lin[..., :2], gyr[..., 2:]], -1).flatten(1)
    return {
      "joints": state["q"][:, 3:],
      "to_target": to_target,
      "body_velocities": vels,
    }

  @classmethod
  def reset(cls, cfg: Any, state: Any, keys: Tensor):
    del state
    mdl = cls.mdl(cfg)
    kj, kp, kx, ky = prng.split(keys, 4).unbind(-2)
    q, v = cls._reset_qv(cfg, keys)
    q = randomize_limited_and_rotational_joints(mdl, q, kj)
    # target uniform in a 2x2 box, or a 0.3 box with probability 0.2
    box = torch.where(prng.uniform(kp, (), 0.0, 1.0) < 0.2, 0.3, 2.0)
    target = torch.stack([prng.uniform(kx, (), -1.0, 1.0) * box,
                          prng.uniform(ky, (), -1.0, 1.0) * box], 1)
    state = {"q": q, "v": v, "target": target}
    return state, cls._obs(cfg, state, cls._to_target(cfg, state)), \
      cls._discount_info(q)

  @classmethod
  def step(cls, cfg: Any, state: Any, action: Any, keys: Tensor):
    del keys
    new = cls._physics(cfg, state, action.to(torch.float32))
    state = {**state, **new}
    mdl = cls.mdl(cfg)
    target_size = float(mdl.geom_size[mdl.geom_name2id["target"], 0])
    to_target = cls._to_target(cfg, state)
    reward = tolerance(_norm(to_target), 0.0, target_size, 5 * target_size,
                       0.1, LONG_TAIL)
    return cls._done(cfg, state, cls._obs(cfg, state, to_target), reward)


class DmcFishJaxEnv(DmcDeviceEnv):
  """dmc fish upright/swim on-device (``envpool/mujoco/dmc/fish.h``):
  quaternion free root in a zero-gravity viscous medium."""

  name = "DmcFishJax"
  model_name = "fish"
  _JOINTS = (
    "tail1", "tail_twist", "tail2", "finright_roll", "finright_pitch",
    "finleft_roll", "finleft_pitch",
  )

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"frame_skip": 10, "task_name": "upright"}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    if str(cfg.task_name) not in ("upright", "swim"):
      raise RuntimeError(
        f"Unknown task_name {cfg.task_name} for dmc fish."
      )
    return {
      "obs:joint_angles": ArraySpec(np.float32, (7,)),
      "obs:upright": ArraySpec(np.float32, ()),
      "obs:velocity": ArraySpec(np.float32, (13,)),
      "obs:target": ArraySpec(np.float32, (3,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float32, (-1, 5), -1.0, 1.0)}

  @classmethod
  def _joint_qadr(cls, mdl) -> List[int]:
    # the hinge joints after the free root, in declaration order (the
    # replica declares them in the order of _JOINTS)
    return [mdl.jnt_qadr[j] for j, t in enumerate(mdl.jnt_type) if t == _HINGE]

  @classmethod
  def _readouts(cls, cfg, state):
    """(upright ``[N]``, the mouth-to-target vector in the torso frame
    ``[N, 3]``) from one kinematics pass."""
    mdl = cls.mdl(cfg)
    xpos, xmat, _, _ = de.fk(mdl, state["q"])
    torso = xmat[mdl.body_name2id["torso"]]
    d = state["target"] - _geom(mdl, xpos, xmat, "mouth")
    return torso[:, 2, 2], de._vm(d, torso)

  @classmethod
  def _obs(cls, cfg, state, upright, to_target):
    qadr = cls._joint_qadr(cls.mdl(cfg))
    q = state["q"]
    if str(cfg.task_name) != "swim":
      to_target = torch.zeros_like(to_target)
    return {
      "joint_angles": q[:, qadr[0]:qadr[-1] + 1],
      "upright": upright,
      "velocity": state["v"],
      "target": to_target,
    }

  @classmethod
  def reset(cls, cfg: Any, state: Any, keys: Tensor):
    del state
    mdl = cls.mdl(cfg)
    kq, kj, kt = prng.split(keys, 3).unbind(-2)
    q, v = cls._reset_qv(cfg, keys)
    quat = prng.normal(kq, (4,))
    q = _set(q, 3, quat / _norm(quat)[:, None])
    qadr = cls._joint_qadr(mdl)
    assert qadr == list(range(qadr[0], qadr[0] + len(qadr)))
    q = _set(q, qadr[0], prng.uniform(kj, (len(qadr),), -0.2, 0.2))
    if str(cfg.task_name) == "swim":
      t = prng.uniform(kt, (3,), 0.0, 1.0)
      target = torch.stack([_fma(t[:, 0], 0.8, -0.4), _fma(t[:, 1], 0.8, -0.4),
                            _fma(t[:, 2], 0.2, 0.1)], 1)
    else:
      g = mdl.geom_name2id["target"]
      target = de.consts_on(mdl, torch.float32, keys.device)["geom_pos"][g]
      target = target.expand(keys.shape[0], 3).clone()
    state = {"q": q, "v": v, "target": target}
    upright, to_target = cls._readouts(cfg, state)
    return state, cls._obs(cfg, state, upright, to_target), \
      cls._discount_info(q)

  @classmethod
  def step(cls, cfg: Any, state: Any, action: Any, keys: Tensor):
    del keys
    new = cls._physics(cfg, state, action.to(torch.float32))
    state = {**state, **new}
    mdl = cls.mdl(cfg)
    upright, to_target = cls._readouts(cfg, state)
    if str(cfg.task_name) == "swim":
      radii = float(
        mdl.geom_size[mdl.geom_name2id["mouth"], 0]
        + mdl.geom_size[mdl.geom_name2id["target"], 0]
      )
      in_target = tolerance(_norm(to_target), 0.0, radii, 2 * radii)
      reward = (7 * in_target + 0.5 * (upright + 1)) / 8
    else:
      reward = tolerance(upright, 1.0, 1.0, 1.0)
    return cls._done(cfg, state, cls._obs(cfg, state, upright, to_target),
                     reward)


def _point_normal_forces(cd, f_rows: Tensor, c: Dict[str, Tensor]) -> Tensor:
  """Per-candidate-point contact normal force ``[N, P]`` from the solved
  row forces (the layout of ``assemble_rows``: limits, tendons, condim-1
  points, then 4 pyramid facets per condim-3 point; a facet sum is
  mj_contactForce's normal component). ``c`` are the contact constants."""
  L = len(cd.lim_dof) + cd.ten_site_body.shape[0]  # rows before contacts
  n_one = int((cd.point_condim == 1).sum())
  parts = []
  if n_one:
    parts.append(f_rows[:, L:L + n_one])
  if n_one < cd.point_b1.shape[0]:
    parts.append(f_rows[:, L + n_one:].unflatten(1, (-1, 4)).sum(2))
  if len(parts) == 1:
    return parts[0]
  return torch.cat(parts, 1)[:, c["pt_order"]]


@functools.lru_cache(maxsize=32)
def _touch_table(key: de._ByIdentity, sites: tuple, dtype: torch.dtype,
                 device: torch.device):
  """The touch sensors' constants: the sites' ids (a device tensor), bodies
  and squared radii
  (``[k]`` of ``dtype``), and per site and candidate point whether the point
  is on the site's body as body1 or as either body (``[k, P]`` masks)."""
  mdl = key.mdl
  cd = mdl.contacts
  sid = [mdl.site_name2id[s] for s in sites]
  bodies = np.asarray([mdl.site_body[s] for s in sid])
  on_b1 = cd.point_b1[None] == bodies[:, None]
  on_body = on_b1 | (cd.point_b2[None] == bodies[:, None])
  radius = mdl.site_size[sid, 0]
  return (torch.as_tensor(sid, dtype=torch.int64, device=device), bodies.tolist(),
          torch.as_tensor(radius * radius, dtype=dtype, device=device),
          torch.as_tensor(on_b1, device=device)[..., None],
          torch.as_tensor(on_body, device=device))


def site_touch_forces(mdl: DeviceModel, q: Tensor, f_rows: Tensor,
                      site_names: Sequence[str], mut=None) -> Tensor:
  """mj touch sensors (mjSENS_TOUCH) ``[N, k]``: per site, the sum of
  contact normal forces for contacts on the site's body whose RAY, cast
  from the contact point along the contact normal oriented AWAY from that
  body (toward the other body), meets the (sphere) site zone (mj's
  ``mju_rayGeom`` test, not point-in-sphere). The JAX package pinned the
  orientation against mujoco 3.10 (4000 random finger states). ``q`` and
  ``f_rows`` are the last forward evaluation's state and row forces from
  ``step_smooth(want_aux=True)``, exactly the state mjData's sensordata
  was computed at; ``mut`` the body-pose overrides of that step. All sites
  in one pass."""
  cd = mdl.contacts
  sid, bodies, radius2, on_b1, on_body = _touch_table(
    de._ByIdentity(mdl), tuple(site_names), q.dtype, q.device)
  xpos, xmat, _, _ = de.fk(mdl, q, mut)
  pos, _, n, _, _, _ = dc.contact_points(mdl, xpos, xmat)
  normal = _point_normal_forces(cd, f_rows, dc._cconsts(mdl, q))
  c = de.consts_on(mdl, q.dtype, q.device)
  rot = torch.stack([xmat[b] for b in bodies], 1)           # [N, k, 3, 3]
  center = torch.stack([xpos[b] for b in bodies], 1) + de._mv(rot, c["site_pos"][sid])
  # normals point body1 -> body2 = away from body1: kept for body1 sites,
  # flipped for body2 sites so that the ray leaves the sensor body
  ray = torch.where(on_b1, n[:, None], -n[:, None])         # [N, k, P, 3]
  pc = pos[:, None] - center[:, :, None]
  bq = (ray * pc).sum(-1)
  cc = (pc * pc).sum(-1) - radius2[:, None]
  hit = (cc <= 0) | ((bq <= 0) & (bq * bq >= cc))
  return torch.where(on_body & hit, normal[:, None], 0.0).sum(-1)


class DmcFingerJaxEnv(DmcDeviceEnv):
  """dmc finger spin/turn_easy/turn_hard on-device
  (``envpool/mujoco/dmc/finger.h``): capsule-capsule contacts between the
  planar finger and the spinner, log1p touch observations, and the
  collision-free episode-init redraw expressed as a static K-candidate
  selection instead of the host's rejection loop (finger.h:202-218)."""

  name = "DmcFingerJax"
  _EASY_TARGET = 0.07
  _HARD_TARGET = 0.03
  _SPIN_VELOCITY = 15.0
  # candidate joint draws per episode init. The reference rejection-
  # samples up to 1000 times and throws on failure (finger.h:202-218);
  # the static-shape analogue draws a fixed candidate set and takes the
  # first collision-free one. The JAX package measured against real
  # mujoco over 1e5 uniform joint draws on this model: not one produced an
  # active contact (rate < 1e-5), so P(all 8 colliding) < 1e-40, and the
  # least-penetrating fallback is unreachable in practice.
  _INIT_DRAWS = 8

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"frame_skip": 2, "task_name": "spin"}

  @classmethod
  def mdl(cls, cfg: Any) -> DeviceModel:
    return _finger_model(str(cfg.task_name) == "spin")

  @classmethod
  def _is_spin(cls, cfg: Any) -> bool:
    task = str(cfg.task_name)
    if task not in ("spin", "turn_easy", "turn_hard"):
      raise RuntimeError(f"Unknown task_name {task} for dmc finger.")
    return task == "spin"

  @classmethod
  def _target_size(cls, cfg: Any) -> float:
    """Effective target site radius: the per-task mutation for turn
    tasks (finger.h:138), the replica's default site size for spin."""
    task = str(cfg.task_name)
    if task == "turn_easy":
      return cls._EASY_TARGET
    if task == "turn_hard":
      return cls._HARD_TARGET
    mdl = cls.mdl(cfg)
    return float(mdl.site_size[mdl.site_name2id["target"], 0])

  @classmethod
  def state_spec(cls, cfg: Any) -> Dict[str, ArraySpec]:
    # like the reference spec (finger.h:48-56) and the host tier, the
    # target keys are present for ALL tasks; spin simply never moves the
    # target site, so they report the default site position
    cls._is_spin(cfg)  # validates task_name
    return {
      "obs:position": ArraySpec(np.float32, (4,)),
      "obs:velocity": ArraySpec(np.float32, (3,)),
      "obs:touch": ArraySpec(np.float32, (2,)),
      "obs:target_position": ArraySpec(np.float32, (2,)),
      "obs:dist_to_target": ArraySpec(np.float32, ()),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float32, (-1, 2), -1.0, 1.0)}

  @classmethod
  def _obs(cls, cfg, state):
    mdl = cls.mdl(cfg)
    q, v = state["q"], state["v"]
    xpos, xmat, _, _ = de.fk(mdl, q)
    spinner = _site(mdl, xpos, xmat, "spinner_site")[:, 0::2]
    tip = _site(mdl, xpos, xmat, "tip")[:, 0::2] - spinner
    target = state["target"] - spinner
    if cls._is_spin(cfg):
      # the reference writes target_position/dist_to_target for turn
      # tasks ONLY; for spin the zero-filled Allocate() leaves them 0
      # (finger.h:187-195)
      target = torch.zeros_like(target)
      dist = torch.zeros_like(q[:, 0])
    else:
      dist = _norm(target - tip) - cls._target_size(cfg)
    return {
      "position": torch.cat([q[:, :2], tip], 1),
      "velocity": v,
      "touch": torch.log1p(state["touch"]),
      "target_position": target,
      "dist_to_target": dist,
    }

  @classmethod
  def reset(cls, cfg: Any, state: Any, keys: Tensor):
    del state
    mdl = cls.mdl(cfg)
    n = keys.shape[0]
    kt, kj = prng.split(keys).unbind(-2)
    q0, v = cls._reset_qv(cfg, keys)
    # collision-free random joint angles: K candidates, the first with
    # every contact candidate separated (ncon == 0)
    ks = prng.split(kj, cls._INIT_DRAWS).flatten(0, 1)
    qc = randomize_limited_and_rotational_joints(
      mdl, q0.repeat_interleave(cls._INIT_DRAWS, 0), ks)
    q = _take(qc, _pick_collision_free(mdl, qc, n))
    state = {"q": q, "v": v, "touch": torch.zeros_like(q[:, :2])}
    if cls._is_spin(cfg):
      # spin never moves the target site: the world position of the
      # (worldbody) "target" site, constant
      # (two fills on the device, not a host-to-device copy: a reset may be
      # captured)
      s = mdl.site_name2id["target"]
      state["target"] = torch.stack([
        torch.full((n,), float(mdl.site_pos[s][i]), dtype=q.dtype, device=q.device)
        for i in (0, 2)
      ], 1)
    else:
      # finger.h:127-139: target on the circle of radius
      # sum(geom_size[cap1]) about the (static) hinge anchor
      g = mdl.geom_name2id["cap1"]
      radius = float(np.sum(mdl.geom_size[g]))
      anchor = mdl.body_pos[mdl.geom_body[g]]  # world-fixed, jnt_pos 0
      angle = prng.uniform(kt, (), -math.pi, math.pi)
      state["target"] = torch.stack([
        _fma(torch.sin(angle), radius, anchor[0]),
        _fma(torch.cos(angle), radius, anchor[2]),
      ], 1)
    return state, cls._obs(cfg, state), cls._discount_info(q)

  @classmethod
  def step(cls, cfg: Any, state: Any, action: Any, keys: Tensor):
    del keys
    mdl = cls.mdl(cfg)
    q, v, aux = de.step_smooth(mdl, state["q"], state["v"],
                               action.to(torch.float32),
                               nstep=int(cfg.frame_skip), want_aux=True)
    q_fwd, _, _, f_rows = aux
    touch = site_touch_forces(mdl, q_fwd, f_rows,
                              ["touchtop_site", "touchbottom_site"])
    state = {**state, "q": q, "v": v, "touch": touch}
    obs = cls._obs(cfg, state)
    if cls._is_spin(cfg):
      reward = (v[:, 2] <= -cls._SPIN_VELOCITY).to(torch.float32)
    else:
      reward = (obs["dist_to_target"] <= 0).to(torch.float32)
    return cls._done(cfg, state, obs, reward)


@functools.lru_cache(maxsize=2)
def _finger_model(spin: bool) -> DeviceModel:
  """finger's committed model; spin lowers the spinner hinge's damping to
  0.03 (finger.h:123-125, a model mutation baked in per task). Cached, so
  each task has one model object (the engine caches constants by
  identity)."""
  base = load_dmc_model("finger")
  if not spin:
    return base
  hinge = [j for j in range(len(base.jnt_type)) if not base.jnt_limited[j]][0]
  damping = np.array(base.dof_damping, copy=True)
  damping[base.jnt_dof[hinge]] = 0.03
  return base._replace(dof_damping=damping)


class DmcHopperJaxEnv(DmcDeviceEnv):
  """dmc hopper stand/hop on-device (``envpool/mujoco/dmc/hopper.h``):
  contacts and the two log1p touch observations via
  ``site_touch_forces``."""

  name = "DmcHopperJax"
  model_name = "hopper"
  _STAND_HEIGHT = 0.6
  _HOP_SPEED = 2.0

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"frame_skip": 4, "task_name": "stand"}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    if str(cfg.task_name) not in ("stand", "hop"):
      raise RuntimeError(
        f"Unknown task_name {cfg.task_name} for dmc hopper."
      )
    return {
      "obs:position": ArraySpec(np.float32, (6,)),
      "obs:velocity": ArraySpec(np.float32, (7,)),
      "obs:touch": ArraySpec(np.float32, (2,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float32, (-1, 4), -1.0, 1.0)}

  @classmethod
  def _obs(cls, cfg, state):
    return {
      "position": state["q"][:, 1:],
      "velocity": state["v"],
      "touch": torch.log1p(state["touch"]),
    }

  @classmethod
  def reset(cls, cfg: Any, state: Any, keys: Tensor):
    del state
    mdl = cls.mdl(cfg)
    q, v = cls._reset_qv(cfg, keys)
    q = randomize_limited_and_rotational_joints(mdl, q, keys)
    # unlimited root slides stay 0 => the foot starts airborne: touch 0
    state = {"q": q, "v": v, "touch": torch.zeros_like(q[:, :2])}
    return state, cls._obs(cfg, state), cls._discount_info(q)

  @classmethod
  def step(cls, cfg: Any, state: Any, action: Any, keys: Tensor):
    del keys
    mdl = cls.mdl(cfg)
    ctrl = action.to(torch.float32)
    q, v, aux = de.step_smooth(mdl, state["q"], state["v"], ctrl,
                               nstep=int(cfg.frame_skip), want_aux=True)
    q_fwd, _, _, f_rows = aux
    touch = site_touch_forces(mdl, q_fwd, f_rows, ["toe_site", "heel_site"])
    state = {"q": q, "v": v, "touch": touch}
    kin = de.fk(mdl, q)
    xpos, xmat = kin[:2]
    c = de.consts_on(mdl, q.dtype, q.device)

    def xipos_z(name):
      b = mdl.body_name2id[name]
      return (xpos[b] + de._mv(xmat[b], c["body_ipos"][b]))[:, 2]
    height = xipos_z("torso") - xipos_z("foot")
    standing = tolerance(height, cls._STAND_HEIGHT, 2.0)
    if str(cfg.task_name) == "hop":
      speed = de.subtree_linvel_at(mdl, kin, v, "torso")[:, 0]
      hop = tolerance(speed, cls._HOP_SPEED, _INF, cls._HOP_SPEED / 2, 0.5,
                      LINEAR)
      reward = standing * hop
    else:
      # the reference reads the ctrlrange-clamped data_->ctrl (hopper.h:125)
      clamped = torch.clamp(ctrl, c["ctrl_range"][:, 0].float(),
                            c["ctrl_range"][:, 1].float())
      small_control = (
        tolerance(clamped, 0.0, 0.0, 1.0, 0.0, QUADRATIC).mean(1) + 4) / 5
      reward = standing * small_control
    return cls._done(cfg, state, cls._obs(cfg, state), reward)


class DmcWalkerJaxEnv(DmcDeviceEnv):
  """dmc walker stand/walk/run on-device
  (``envpool/mujoco/dmc/walker.h``)."""

  name = "DmcWalkerJax"
  model_name = "walker"
  _STAND_HEIGHT = 1.2
  _SPEEDS = {"stand": 0.0, "walk": 1.0, "run": 8.0}

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"frame_skip": 10, "task_name": "stand"}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    if str(cfg.task_name) not in ("stand", "walk", "run"):
      raise RuntimeError(
        f"Unknown task_name {cfg.task_name} for dmc walker."
      )
    return {
      "obs:orientations": ArraySpec(np.float32, (14,)),
      "obs:height": ArraySpec(np.float32, (-1,)),
      "obs:velocity": ArraySpec(np.float32, (9,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float32, (-1, 6), -1.0, 1.0)}

  @classmethod
  def _obs(cls, cfg, state, xpos, xmat):
    mdl = cls.mdl(cfg)
    rot = torch.stack(xmat[1:8], 1)                         # [N, 7, 3, 3]
    return {
      "orientations": torch.stack([rot[:, :, 0, 0], rot[:, :, 0, 2]],
                                  2).flatten(1),
      "height": xpos[mdl.body_name2id["torso"]][:, 2],
      "velocity": state["v"],
    }

  @classmethod
  def reset(cls, cfg: Any, state: Any, keys: Tensor):
    del state
    mdl = cls.mdl(cfg)
    q, v = cls._reset_qv(cfg, keys)
    q = randomize_limited_and_rotational_joints(mdl, q, keys)
    state = {"q": q, "v": v}
    xpos, xmat, _, _ = de.fk(mdl, q)
    return state, cls._obs(cfg, state, xpos, xmat), cls._discount_info(q)

  @classmethod
  def step(cls, cfg: Any, state: Any, action: Any, keys: Tensor):
    del keys
    state = cls._physics(cfg, state, action.to(torch.float32))
    mdl = cls.mdl(cfg)
    q, v = state["q"], state["v"]
    kin = de.fk(mdl, q)
    xpos, xmat = kin[:2]
    torso = mdl.body_name2id["torso"]
    height = xpos[torso][:, 2]
    upright = (1 + xmat[torso][:, 2, 2]) / 2
    standing = tolerance(height, cls._STAND_HEIGHT, _INF,
                         cls._STAND_HEIGHT / 2)
    stand_reward = (3 * standing + upright) / 4
    move_speed = cls._SPEEDS[str(cfg.task_name)]
    if move_speed == 0:
      reward = stand_reward
    else:
      move = tolerance(de.subtree_linvel_at(mdl, kin, v, "torso")[:, 0],
                       move_speed, _INF, move_speed / 2, 0.5, LINEAR)
      reward = stand_reward * (5 * move + 1) / 6
    return cls._done(cfg, state, cls._obs(cfg, state, xpos, xmat), reward)


class DmcCheetahJaxEnv(DmcDeviceEnv):
  """dmc cheetah run on-device (``envpool/mujoco/dmc/cheetah.h``): the full
  contact pipeline (plane/capsule, pyramidal Newton). Episode init
  randomizes limited joints then settles 200 physics steps
  (cheetah.h:86-100), one ``step_smooth(nstep=200)`` call where the JAX
  package scans."""

  name = "DmcCheetahJax"
  model_name = "cheetah"
  _RUN_SPEED = 10.0
  _SETTLE_STEPS = 200

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"frame_skip": 1, "task_name": "run"}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    if str(cfg.task_name) != "run":
      raise RuntimeError(
        f"Unknown task_name {cfg.task_name} for dmc cheetah."
      )
    return {
      "obs:position": ArraySpec(np.float32, (8,)),
      "obs:velocity": ArraySpec(np.float32, (9,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float32, (-1, 6), -1.0, 1.0)}

  @classmethod
  def _obs(cls, cfg, state):
    return {"position": state["q"][:, 1:], "velocity": state["v"]}

  @classmethod
  def reset(cls, cfg: Any, state: Any, keys: Tensor):
    del state
    mdl = cls.mdl(cfg)
    q, v = cls._reset_qv(cfg, keys)
    # cheetah.h:83-98 randomizes LIMITED joints only; the unlimited
    # rootx/rootz/rooty stay 0 (torso level) before the 200-step settle
    q = randomize_limited_and_rotational_joints(mdl, q, keys,
                                                limited_only=True)
    # settle: 200 passive steps (ctrl = 0)
    q, v = de.step_smooth(mdl, q, v, q.new_zeros(q.shape[0], len(mdl.act_dof)),
                          nstep=cls._SETTLE_STEPS)
    state = {"q": q, "v": v}
    return state, cls._obs(cfg, state), cls._discount_info(q)

  @classmethod
  def step(cls, cfg: Any, state: Any, action: Any, keys: Tensor):
    del keys
    state = cls._physics(cfg, state, action.to(torch.float32))
    mdl = cls.mdl(cfg)
    speed = de.subtree_linvel(mdl, state["q"], state["v"], "torso")[:, 0]
    reward = tolerance(speed, cls._RUN_SPEED, _INF, cls._RUN_SPEED, 0.0,
                       LINEAR)
    return cls._done(cfg, state, cls._obs(cfg, state), reward)


class DmcBallInCupJaxEnv(DmcDeviceEnv):
  """dmc ball_in_cup catch on-device
  (``envpool/mujoco/dmc/ball_in_cup.h``): sphere-capsule contacts plus the
  string as a limited spatial tendon constraint row."""

  name = "DmcBallInCupJax"
  model_name = "ball_in_cup"
  _INIT_DRAWS = 8  # candidate ball drops; see DmcFingerJaxEnv._INIT_DRAWS

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"frame_skip": 10, "task_name": "catch"}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    if str(cfg.task_name) != "catch":
      raise RuntimeError(
        f"Unknown task_name {cfg.task_name} for dmc ball_in_cup."
      )
    return {
      "obs:position": ArraySpec(np.float32, (4,)),
      "obs:velocity": ArraySpec(np.float32, (4,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float32, (-1, 2), -1.0, 1.0)}

  @classmethod
  def _obs(cls, cfg, state):
    return {"position": state["q"], "velocity": state["v"]}

  @classmethod
  def _in_target(cls, cfg, state):
    """Ball center inside the target box site, shrunk by the ball radius
    (ball_in_cup.h:142-152)."""
    mdl = cls.mdl(cfg)
    xpos, xmat, _, _ = de.fk(mdl, state["q"])
    tpos = _site(mdl, xpos, xmat, "target")
    ball = xpos[mdl.body_name2id["ball"]]
    d = torch.abs((tpos - ball)[:, 0::2])
    s = mdl.site_name2id["target"]
    size = np.asarray(mdl.site_size[s])[[0, 2]]
    ball_size = float(mdl.geom_size[mdl.geom_name2id["ball"], 0])
    lim = np.float32(size - ball_size)
    return (d[:, 0] < float(lim[0])) & (d[:, 1] < float(lim[1]))

  @classmethod
  def reset(cls, cfg: Any, state: Any, keys: Tensor):
    del state
    mdl = cls.mdl(cfg)
    n = keys.shape[0]
    q0, v = cls._reset_qv(cfg, keys)
    # collision-free random ball drop (ball_in_cup.h:86-97): K candidate
    # (x, z) draws, the first with every contact separated
    kx, kz = prng.split(prng.split(keys, cls._INIT_DRAWS).flatten(0, 1)).unbind(-2)
    qc = q0.repeat_interleave(cls._INIT_DRAWS, 0)
    qc = _set(qc, 2, prng.uniform(kx, (), -0.2, 0.2))
    qc = _set(qc, 3, prng.uniform(kz, (), 0.2, 0.5))
    state = {"q": _take(qc, _pick_collision_free(mdl, qc, n)), "v": v}
    return state, cls._obs(cfg, state), cls._discount_info(v)

  @classmethod
  def step(cls, cfg: Any, state: Any, action: Any, keys: Tensor):
    del keys
    state = cls._physics(cfg, state, action.to(torch.float32))
    reward = cls._in_target(cfg, state).to(torch.float32)
    return cls._done(cfg, state, cls._obs(cfg, state), reward)


class DmcManipulatorJaxEnv(DmcDeviceEnv):
  """dmc manipulator bring_ball/bring_peg/insert_ball/insert_peg on-device
  (``envpool/mujoco/dmc/manipulator.h``): a planar arm with a two-finger
  gripper (a fixed-tendon grasp actuator), props with capsule and box
  contacts against the receptacles, and per-episode receptacle and target
  poses carried in the state (``target``: x, z, angle) and applied through
  the engine's body-pose override (``fk``'s ``mut``), where the reference
  sets mjModel's body_pos and body_quat (manipulator.h:186-210).

  The reset draws ``_INIT_DRAWS`` candidates per lane (arm, target and
  object) and keeps the first collision-free one, all candidates in one
  kinematics and narrow-phase pass."""

  name = "DmcManipulatorJax"
  model_name = staticmethod(lambda task: f"manipulator_{task}")
  _CLOSE = 0.01
  _P_IN_TARGET = 0.1
  _P_IN_HAND = 0.1
  _TOUCH_SITES = (
    "palm_site", "finger_site", "thumb_site", "fingertip_site",
    "thumbtip_site",
  )
  _INIT_DRAWS = 8
  _TASKS = ("bring_ball", "bring_peg", "insert_ball", "insert_peg")
  # qpos addresses: the replica declares the 8 arm joints, then the
  # object's x, z and angle
  _ARM, _OBJ = slice(0, 8), slice(8, 11)

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"frame_skip": 10, "task_name": "bring_ball"}

  @staticmethod
  def _use_peg(cfg) -> bool:
    return str(cfg.task_name) in ("bring_peg", "insert_peg")

  @staticmethod
  def _insert(cfg) -> bool:
    return str(cfg.task_name) in ("insert_ball", "insert_peg")

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    if str(cfg.task_name) not in DmcManipulatorJaxEnv._TASKS:
      raise RuntimeError(
        f"Unknown task_name {cfg.task_name} for dmc manipulator."
      )
    return {
      "obs:arm_pos": ArraySpec(np.float32, (8, 2)),
      "obs:arm_vel": ArraySpec(np.float32, (8,)),
      "obs:touch": ArraySpec(np.float32, (5,)),
      "obs:hand_pos": ArraySpec(np.float32, (4,)),
      "obs:object_pos": ArraySpec(np.float32, (4,)),
      "obs:object_vel": ArraySpec(np.float32, (3,)),
      "obs:target_pos": ArraySpec(np.float32, (4,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float32, (-1, 5), -1.0, 1.0)}

  @classmethod
  def _target_body(cls, cfg) -> str:
    return "target_peg" if cls._use_peg(cfg) else "target_ball"

  @classmethod
  def _mut(cls, cfg, target: Tensor):
    """The body-pose overrides ``{body: (pos [N, 3], rotm [N, 3, 3])}`` of
    the episode targets ``[N, 3]`` (x, z, angle about y): the target body,
    and for the insert tasks the receptacle, at (x, body_pos y, z)."""
    mdl = cls.mdl(cfg)
    tx, tz, ang = target.unbind(1)
    c, s = torch.cos(ang), torch.sin(ang)
    zero, one = torch.zeros_like(c), torch.ones_like(c)
    rot = torch.stack([torch.stack([c, zero, s], 1),
                       torch.stack([zero, one, zero], 1),
                       torch.stack([-s, zero, c], 1)], 1)
    names = [cls._target_body(cfg)]
    if cls._insert(cfg):
      names.append("slot" if cls._use_peg(cfg) else "cup")
    mut = {}
    for name in names:
      b = mdl.body_name2id[name]
      y = torch.full_like(tx, float(np.float32(mdl.body_pos[b][1])))
      mut[b] = (torch.stack([tx, y, tz], 1), rot)
    return mut

  @classmethod
  def _obs(cls, cfg, state, xpos):
    """The observation from the state and a kinematics pass under the
    state's overrides. The model is planar (every rotation about +y), so a
    body's (qw, qy) is the half-angle pair of its summed joint angles, as
    manipulator.h's Body2dPose reads xquat (joint quaternions compose
    without wrapping)."""
    mdl = cls.mdl(cfg)
    q, v = state["q"], state["v"]
    arm_q = q[:, cls._ARM]

    def pose2d(body, phi):
      b = mdl.body_name2id[body]
      return torch.stack([xpos[b][:, 0], xpos[b][:, 2], torch.cos(phi / 2),
                          torch.sin(phi / 2)], 1)
    hand_phi = q[:, 0] + q[:, 1] + q[:, 2] + q[:, 3]
    return {
      "arm_pos": torch.stack([torch.sin(arm_q), torch.cos(arm_q)], 2),
      "arm_vel": v[:, cls._ARM],
      "touch": torch.log1p(state["touch"]),
      "hand_pos": pose2d("hand", hand_phi),
      "object_pos": pose2d("peg" if cls._use_peg(cfg) else "ball", q[:, 10]),
      "object_vel": v[:, cls._OBJ],
      "target_pos": pose2d(cls._target_body(cfg), state["target"][:, 2]),
    }

  @classmethod
  def _reward(cls, cfg, xpos, xmat):
    mdl = cls.mdl(cfg)

    def close(a, b):
      d = _norm(_site(mdl, xpos, xmat, a) - _site(mdl, xpos, xmat, b))
      return tolerance(d, 0.0, cls._CLOSE, cls._CLOSE * 2)

    if cls._use_peg(cfg):
      grasping = (close("peg_grasp", "grasp") + close("peg_pinch", "pinch")) / 2.0
      bringing = (close("peg", "target_peg")
                  + close("target_peg_tip", "peg_tip")) / 2.0
      return torch.maximum(bringing, grasping / 3.0)
    return close("ball", "target_ball")

  @classmethod
  def _candidates(cls, cfg: Any, keys: Tensor):
    """The reset's ``_INIT_DRAWS`` candidates per lane, lane-major: (q
    ``[n k, nq]``, v, target ``[n k, 3]``). Each candidate takes 10 keys:
    the arm joints', the target x's, and 7 more (the target's z and angle,
    the object's init choice, its uniform x, z, angle and x velocity)."""
    mdl = cls.mdl(cfg)
    k = cls._INIT_DRAWS
    q0, v0 = cls._reset_qv(cfg, keys)
    ks = prng.split(prng.split(keys, k).flatten(0, 1), 10)   # [n k, 10, 2]
    qc = q0.repeat_interleave(k, 0)
    for i in range(8):
      if mdl.jnt_limited[i]:
        lo, hi = float(mdl.jnt_range[i, 0]), float(mdl.jnt_range[i, 1])
      else:
        lo, hi = -math.pi, math.pi
      qc[:, i] = prng.uniform(ks[:, i], (), lo, hi)
    qc[:, 4] = qc[:, 6]  # finger := thumb (manipulator.h:178)
    tx = prng.uniform(ks[:, 8], (), -0.4, 0.4)
    kz, ka, kc, kx2, kz2, kang, kvx = prng.split(ks[:, 9], 7).unbind(-2)
    tz = prng.uniform(kz, (), 0.1, 0.4)
    span = math.pi / 3 if cls._insert(cfg) else math.pi
    target = torch.stack([tx, tz, prng.uniform(ka, (), -span, span)], 1)
    # the object: in the target (p = .1), in the hand (p = .1) or uniform
    choice = prng.uniform(kc, (), 0.0, 1.0)
    xpos, xmat, _, _ = de.fk(mdl, qc)
    grasp = _site(mdl, xpos, xmat, "grasp")
    gdir = xmat[mdl.body_name2id["hand"]]
    hand_angle = math.pi - torch.atan2(gdir[:, 2, 0], gdir[:, 0, 0])
    in_tgt = choice <= float(np.float32(cls._P_IN_TARGET))
    in_hand = ~in_tgt & (choice <= float(np.float32(cls._P_IN_TARGET + cls._P_IN_HAND)))

    def place(at_target, in_hand_value, uniform):
      return torch.where(in_tgt, at_target, torch.where(in_hand, in_hand_value, uniform))
    qc[:, 8] = place(tx, grasp[:, 0], prng.uniform(kx2, (), -0.5, 0.5))
    qc[:, 9] = place(tz, grasp[:, 2], prng.uniform(kz2, (), 0.0, 0.7))
    qc[:, 10] = place(target[:, 2], hand_angle,
                      prng.uniform(kang, (), 0.0, 2 * math.pi))
    vc = v0.repeat_interleave(k, 0)
    vc[:, 8] = torch.where(in_tgt | in_hand, 0.0, prng.uniform(kvx, (), -5.0, 5.0))
    return qc, vc, target

  @classmethod
  def reset(cls, cfg: Any, state: Any, keys: Tensor):
    del state
    mdl = cls.mdl(cfg)
    n = keys.shape[0]
    qc, vc, target = cls._candidates(cfg, keys)
    pick = _pick_collision_free(mdl, qc, n, cls._mut(cfg, target))
    state = {"q": _take(qc, pick), "v": _take(vc, pick),
             "touch": torch.zeros(n, 5, dtype=torch.float32, device=keys.device),
             "target": _take(target, pick)}
    xpos = de.fk(mdl, state["q"], cls._mut(cfg, state["target"]))[0]
    return state, cls._obs(cfg, state, xpos), cls._discount_info(keys)

  @classmethod
  def step(cls, cfg: Any, state: Any, action: Any, keys: Tensor):
    del keys
    mdl = cls.mdl(cfg)
    mut = cls._mut(cfg, state["target"])
    q, v, aux = de.step_smooth(mdl, state["q"], state["v"],
                               action.to(torch.float32),
                               nstep=int(cfg.frame_skip), want_aux=True, mut=mut)
    q_fwd, _, _, f_rows = aux
    touch = site_touch_forces(mdl, q_fwd, f_rows, cls._TOUCH_SITES, mut=mut)
    state = {**state, "q": q, "v": v, "touch": touch}
    xpos, xmat, _, _ = de.fk(mdl, q, mut)
    return cls._done(cfg, state, cls._obs(cfg, state, xpos),
                     cls._reward(cfg, xpos, xmat))


class _DmcHumanoidRewardMixin:
  """The humanoid reward recipe (humanoid.h:144-178): standing x upright x
  small-control, times dont_move (speed 0) or the (5 move + 1)/6 term."""

  @classmethod
  def _reward(cls, cfg, ctrl, head_z, upright_v, comv):
    standing = tolerance(head_z, cls._STAND_HEIGHT, _INF,
                         cls._STAND_HEIGHT / 4)
    upright = tolerance(upright_v, 0.9, _INF, 1.9, 0.0, LINEAR)
    stand_reward = standing * upright
    small_control = tolerance(ctrl, 0.0, 0.0, 1.0, 0.0, QUADRATIC).mean(1)
    small_control = (small_control + 4.0) / 5.0
    speed_target = cls._SPEEDS[str(cfg.task_name)]
    if speed_target == 0.0:
      dont_move = (0.5 * tolerance(comv[:, 0], 0.0, 0.0, 2.0)
                   + 0.5 * tolerance(comv[:, 1], 0.0, 0.0, 2.0))
      return small_control * stand_reward * dont_move
    speed = torch.hypot(comv[:, 0], comv[:, 1])
    move = tolerance(speed, speed_target, _INF, speed_target, 0.0, LINEAR)
    move = (5.0 * move + 1.0) / 6.0
    return small_control * stand_reward * move


class DmcHumanoidJaxEnv(_DmcHumanoidRewardMixin, DmcDeviceEnv):
  """dmc humanoid stand/walk/run/run_pure_state on-device
  (``envpool/mujoco/dmc/humanoid.h``): free quaternion root, 21 hinges,
  box feet on the floor via the plane-box corner narrow phase."""

  name = "DmcHumanoidJax"
  model_name = "humanoid"
  # the body whose frame the observation and reward read, and the entry of
  # its rotation that the upright term reads (humanoid.h:170: zz)
  _ROOT = "torso"
  _UPRIGHT = (2, 2)
  _STAND_HEIGHT = 1.4
  _SPEEDS = {
    "stand": 0.0, "walk": 1.0, "run": 10.0, "run_pure_state": 10.0,
  }
  # collision-free draw acceptance is far lower than the planar models'
  # (random root orientation vs the floor); the host rejection loop
  # tries up to 100 (humanoid.h:98-110)
  _INIT_DRAWS = 16
  _EXT_BODIES = ("left_hand", "left_foot", "right_hand", "right_foot")

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"frame_skip": 5, "task_name": "stand"}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    if str(cfg.task_name) not in DmcHumanoidJaxEnv._SPEEDS:
      raise RuntimeError(
        f"Unknown task_name {cfg.task_name} for dmc humanoid."
      )
    return {
      "obs:joint_angles": ArraySpec(np.float32, (21,)),
      "obs:head_height": ArraySpec(np.float32, ()),
      "obs:extremities": ArraySpec(np.float32, (12,)),
      "obs:torso_vertical": ArraySpec(np.float32, (3,)),
      "obs:com_velocity": ArraySpec(np.float32, (3,)),
      "obs:position": ArraySpec(np.float32, (28,)),
      "obs:velocity": ArraySpec(np.float32, (27,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float32, (-1, 21), -1.0, 1.0)}

  @classmethod
  def _obs(cls, cfg, state, xpos, xmat, comv):
    mdl = cls.mdl(cfg)
    q, v = state["q"], state["v"]
    if str(cfg.task_name) == "run_pure_state":
      # the reference writes position+velocity only; the pixels-era
      # fields stay zero-filled (humanoid.h:188-201)
      z = q.new_zeros
      n = q.shape[0]
      return {
        "joint_angles": z(n, 21), "head_height": z(n),
        "extremities": z(n, 12), "torso_vertical": z(n, 3),
        "com_velocity": z(n, 3), "position": q, "velocity": v,
      }
    torso = mdl.body_name2id[cls._ROOT]
    frame = xmat[torso]
    ext = torch.stack([xpos[mdl.body_name2id[b]] for b in cls._EXT_BODIES], 1)
    return {
      "joint_angles": q[:, 7:],
      "head_height": xpos[mdl.body_name2id["head"]][:, 2],
      "extremities": de._vm(ext - xpos[torso][:, None], frame[:, None]).flatten(1),
      "torso_vertical": frame[:, 2],
      "com_velocity": comv,
      "position": q.new_zeros(q.shape[0], 28),
      "velocity": v,
    }

  @classmethod
  def _readouts(cls, cfg, state):
    """(xpos, xmat, the root subtree's COM velocity)."""
    mdl = cls.mdl(cfg)
    kin = de.fk(mdl, state["q"])
    return kin[0], kin[1], de.subtree_linvel_at(mdl, kin, state["v"], cls._ROOT)

  @classmethod
  def reset(cls, cfg: Any, state: Any, keys: Tensor):
    del state
    mdl = cls.mdl(cfg)
    n = keys.shape[0]
    q0, v = cls._reset_qv(cfg, keys)
    ks = prng.split(keys, cls._INIT_DRAWS).flatten(0, 1)
    qc = randomize_limited_and_rotational_joints(
      mdl, q0.repeat_interleave(cls._INIT_DRAWS, 0), ks)
    state = {"q": _take(qc, _pick_collision_free(mdl, qc, n)), "v": v}
    return state, cls._obs(cfg, state, *cls._readouts(cfg, state)), \
      cls._discount_info(v)

  @classmethod
  def step(cls, cfg: Any, state: Any, action: Any, keys: Tensor):
    del keys
    ctrl = action.to(torch.float32)
    state = cls._physics(cfg, state, ctrl)
    mdl = cls.mdl(cfg)
    xpos, xmat, comv = cls._readouts(cfg, state)
    # mj clamps ctrl before writing data.ctrl; the reward reads the
    # clamped value
    reward = cls._reward(
      cfg, torch.clamp(ctrl, -1.0, 1.0),
      xpos[mdl.body_name2id["head"]][:, 2],
      xmat[mdl.body_name2id[cls._ROOT]][:, cls._UPRIGHT[0], cls._UPRIGHT[1]],
      comv,
    )
    return cls._done(cfg, state, cls._obs(cfg, state, xpos, xmat, comv),
                     reward)


class DmcHumanoidCMUJaxEnv(DmcHumanoidJaxEnv):
  """dmc humanoid_CMU stand/run on-device
  (``envpool/mujoco/dmc/humanoid_CMU.h``): the 56-actuated-dof CMU skeleton
  replica (nv 62, 30 bodies, 426 contact candidates), the widest device
  model. The humanoid's reset (16 candidates) and reward recipe, on the
  thorax and head, the upright term the thorax's zy entry
  (humanoid_CMU.h:199-202)."""

  name = "DmcHumanoidCMUJax"
  model_name = "humanoid_cmu"
  _ROOT = "thorax"
  _UPRIGHT = (2, 1)
  _STAND_HEIGHT = 1.4
  _SPEEDS = {"stand": 0.0, "run": 10.0}
  _EXT_BODIES = ("lhand", "lfoot", "rhand", "rfoot")

  @staticmethod
  def default_config() -> Dict[str, Any]:
    return {"frame_skip": 10, "task_name": "stand"}

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    if str(cfg.task_name) not in DmcHumanoidCMUJaxEnv._SPEEDS:
      raise RuntimeError(
        f"Unknown task_name {cfg.task_name} for dmc humanoid_CMU."
      )
    return {
      "obs:joint_angles": ArraySpec(np.float32, (56,)),
      "obs:head_height": ArraySpec(np.float32, ()),
      "obs:extremities": ArraySpec(np.float32, (12,)),
      "obs:torso_vertical": ArraySpec(np.float32, (3,)),
      "obs:com_velocity": ArraySpec(np.float32, (3,)),
      "obs:velocity": ArraySpec(np.float32, (62,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.float32, (-1, 56), -1.0, 1.0)}

  @classmethod
  def _obs(cls, cfg, state, xpos, xmat, comv):
    mdl = cls.mdl(cfg)
    q, v = state["q"], state["v"]
    root = mdl.body_name2id[cls._ROOT]
    frame = xmat[root]
    ext = torch.stack([xpos[mdl.body_name2id[b]] for b in cls._EXT_BODIES], 1)
    return {
      "joint_angles": q[:, 7:],
      "head_height": xpos[mdl.body_name2id["head"]][:, 2],
      "extremities": de._vm(ext - xpos[root][:, None], frame[:, None]).flatten(1),
      "torso_vertical": frame[:, 2],
      "com_velocity": comv,
      "velocity": v,
    }
