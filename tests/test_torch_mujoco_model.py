"""The port's on-device MuJoCo models as data: the committed ``.npz`` files
(``envpool_torch/envs/mujoco/models/``) and the port's own extractor equal
``envpool_tpu.envs.mujoco.device_engine.extract_model`` field by field and
exactly for every gym device model, and the committed dm_control variants
(``models/dmc/``, from the port's copy of the replicas) equal the JAX
package's ``DmcXxxJaxEnv.mdl(cfg)`` for all 15 domains, the contact tables
(``ContactData``) included; the loader and the engine take every model the
JAX engine takes (the cylinder, box and tendon models too)."""

import types

import numpy as np
import pytest
import torch

mujoco = pytest.importorskip("mujoco")
pytest.importorskip("gymnasium")

from envpool_torch.envs.mujoco import device_engine as port_de  # noqa: E402
from envpool_torch.envs.mujoco import device_model as dm  # noqa: E402
from envpool_torch.envs.mujoco.dmc import assets as port_assets  # noqa: E402
from envpool_tpu.envs.mujoco import device_engine as jax_de  # noqa: E402
from envpool_tpu.envs.mujoco.dmc import assets as jax_assets  # noqa: E402
from envpool_tpu.envs.mujoco.dmc import device_domains as jax_dd  # noqa: E402

torch.set_num_threads(1)

MODELS = ["reacher.xml", "inverted_pendulum.xml",
          "inverted_double_pendulum.xml", "swimmer.xml"]
CONTACT_MODELS = [x for x in dm.GYM_DEVICE_XMLS if x not in MODELS]

# dm_control variant -> the JAX class and a task that builds it
DMC_VARIANTS = {
  "pendulum": ("DmcPendulumJaxEnv", "swingup"),
  "cartpole": ("DmcCartpoleJaxEnv", "balance"),
  "cartpole_two_poles": ("DmcCartpoleJaxEnv", "two_poles"),
  "cartpole_three_poles": ("DmcCartpoleJaxEnv", "three_poles"),
  "point_mass": ("DmcPointMassJaxEnv", "hard"),
  "reacher": ("DmcReacherJaxEnv", "easy"),
  "cheetah": ("DmcCheetahJaxEnv", "run"),
  "acrobot": ("DmcAcrobotJaxEnv", "swingup"),
  "ball_in_cup": ("DmcBallInCupJaxEnv", "catch"),
  "hopper": ("DmcHopperJaxEnv", "hop"),
  "walker": ("DmcWalkerJaxEnv", "walk"),
  "finger": ("DmcFingerJaxEnv", "turn_easy"),
  "swimmer6": ("DmcSwimmerJaxEnv", "swimmer6"),
  "swimmer15": ("DmcSwimmerJaxEnv", "swimmer15"),
  "fish": ("DmcFishJaxEnv", "swim"),
  "humanoid": ("DmcHumanoidJaxEnv", "run"),
  "manipulator_bring_ball": ("DmcManipulatorJaxEnv", "bring_ball"),
  "manipulator_bring_peg": ("DmcManipulatorJaxEnv", "bring_peg"),
  "manipulator_insert_ball": ("DmcManipulatorJaxEnv", "insert_ball"),
  "manipulator_insert_peg": ("DmcManipulatorJaxEnv", "insert_peg"),
  "humanoid_cmu": ("DmcHumanoidCMUJaxEnv", "stand"),
}

FREE_BODY = (
  "<mujoco><worldbody>"
  '<body name="b" pos="0 0 1"><freejoint/>'
  '<geom name="g" type="sphere" size=".1" contype="0" conaffinity="0"/>'
  "</body></worldbody></mujoco>"
)


def _assert_models_equal(got, want, tag):
  """Equal field by field: arrays in dtype, shape and value, the rest in
  type and value (tuples element by element), the contact tables too."""
  assert got._fields == want._fields, tag
  for name in want._fields:
    g, w = getattr(got, name), getattr(want, name)
    if isinstance(w, np.ndarray):
      assert isinstance(g, np.ndarray), (tag, name)
      assert g.dtype == w.dtype and g.shape == w.shape, (tag, name)
      np.testing.assert_array_equal(g, w, err_msg=f"{tag} {name}")
    elif name == "contacts":
      assert (g is None) == (w is None), (tag, name)
      if w is not None:
        assert type(g).__name__ == type(w).__name__ == "ContactData"
        _assert_models_equal(g, w, f"{tag} contacts")
    else:
      assert type(g) is type(w) and g == w, (tag, name, g, w)
      if isinstance(w, tuple):
        assert [type(x) for x in g] == [type(x) for x in w], (tag, name)


def _committed(xml):
  """The committed data of a gym model, read without the loader's refusal."""
  return dm.read_model(dm.MODELS_DIR / (xml[:-4] + ".npz"))


@pytest.mark.parametrize("source", ["committed", "port_extractor"])
@pytest.mark.parametrize("xml", MODELS + CONTACT_MODELS)
def test_model_data_equals_jax_extraction(xml, source):
  want = jax_de.extract_model(dm.gym_asset(xml))
  if source == "committed":
    got = _committed(xml)
    _assert_models_equal(dm.load_model(xml), want, f"{xml} loaded")
  else:
    got = dm.extract_model(dm.gym_asset(xml))
  _assert_models_equal(got, want, f"{xml} {source}")


@pytest.mark.parametrize("xml", CONTACT_MODELS)
def test_contact_models_recorded_and_refused(xml):
  """The port's extractor builds the contact tables exactly where the JAX
  package does; the loader takes all seven contact models (Pusher's
  cylinder pairs too: nothing is refused)."""
  want = jax_de.extract_model(dm.gym_asset(xml))
  got = dm.extract_model(dm.gym_asset(xml))
  assert want.contacts is not None and got.contacts is not None
  assert got.contacts.point_b1.shape[0] >= 1
  assert dm.refused_models() == {}
  dm.check_supported(dm.load_model(xml))


def test_loader_refuses_half_cheetah():
  """``check_supported`` refuses no family the JAX engine has:
  half_cheetah's committed data given a cylinder pair (plane-cylinder,
  capsule-cylinder), a box pair or a limited tendon row is accepted."""
  cheetah = _committed("half_cheetah.xml")
  dm.check_supported(cheetah)
  cd = cheetah.contacts
  for change in (dict(pcy_plane=(0,), pcy_cyl=(1,)),
                 dict(cyc_cap=(1,), cyc_cyl=(2,)),
                 dict(pb_plane=(0,), pb_box=(1,)),
                 dict(sb_cap=(1,), sb_box=(2,), sb_three=(True,)),
                 dict(ten_site_body=np.zeros((1, 2), np.int64))):
    dm.check_supported(cheetah._replace(contacts=cd._replace(**change)))


def test_engine_refuses_contacts_and_free_joints(tmp_path):
  """The engine steps Pusher's cylinder contacts (it refuses no contact
  family the JAX engine has) and a free body (``integrate_pos``'
  quaternion branch) under gravity as mj_step does."""
  pusher = dm.extract_model(dm.gym_asset("pusher.xml"))
  q = torch.zeros(2, pusher.nq, dtype=torch.float64)
  q, v = port_de.step_smooth(pusher, q, torch.zeros(2, pusher.nv, dtype=q.dtype),
                             torch.zeros(2, 7, dtype=q.dtype))
  assert torch.isfinite(q).all() and torch.isfinite(v).all()
  path = tmp_path / "free.xml"
  path.write_text(FREE_BODY)
  free = dm.extract_model(str(path))
  assert free.contacts is None
  dm.check_supported(free)
  m = mujoco.MjModel.from_xml_path(str(path))
  d = mujoco.MjData(m)
  d.qvel[:] = [0.1, -0.2, 0.3, 1.0, -2.0, 0.5]
  q0, v0 = d.qpos.copy(), d.qvel.copy()
  for _ in range(20):
    mujoco.mj_step(m, d)
  gq, gv = port_de.step_smooth(
    free, torch.from_numpy(np.tile(q0, (2, 1))),
    torch.from_numpy(np.tile(v0, (2, 1))),
    torch.zeros(2, 0, dtype=torch.float64), nstep=20)
  for got, want in ((gq, d.qpos), (gv, d.qvel)):
    np.testing.assert_allclose(got.numpy(), np.tile(want, (2, 1)),
                               rtol=0, atol=1e-12)


def test_written_models_read_back_equal(tmp_path):
  """``--write`` regenerates what is committed, the gym models and the
  dm_control variants (read back, not bytes: the zip container carries
  times)."""
  refused = dm.write_models(tmp_path)
  assert refused == dm.refused_models()
  assert dm.refused_models(tmp_path / "dmc") == dm.refused_models(
    dm.DMC_MODELS_DIR) == {}
  for xml in dm.GYM_DEVICE_XMLS:
    stem = xml[:-4]
    _assert_models_equal(dm.read_model(tmp_path / f"{stem}.npz"),
                         _committed(xml), xml)
  for name in port_assets.DMC_XMLS:
    _assert_models_equal(dm.read_model(tmp_path / "dmc" / f"{name}.npz"),
                         dm.read_model(dm.DMC_MODELS_DIR / f"{name}.npz"), name)
  for sub in ("", "dmc"):
    assert sorted(p.name for p in (tmp_path / sub).iterdir()) == sorted(
      p.name for p in (dm.MODELS_DIR / sub).iterdir()
    )


def test_dmc_replicas_are_the_jax_packages():
  """The port's copy of the replicas: every string and every template's
  output for each task equal to the JAX package's, and point_mass's
  variant without its tendon transmission too."""
  for name in ("PENDULUM_XML", "POINT_MASS_XML", "REACHER_XML", "CHEETAH_XML",
               "ACROBOT_XML", "BALL_IN_CUP_XML", "DMC_HOPPER_XML",
               "DMC_WALKER_XML", "FINGER_XML", "FISH_XML", "DMC_HUMANOID_XML"):
    assert getattr(port_assets, name) == getattr(jax_assets, name), name
  for task in ("balance", "swingup", "two_poles", "three_poles"):
    assert port_assets.cartpole_xml(task) == jax_assets.cartpole_xml(task)
  for task in ("swimmer6", "swimmer15"):
    assert port_assets.swimmer_xml(task) == jax_assets.swimmer_xml(task)
  for task in ("bring_ball", "bring_peg", "insert_ball", "insert_peg"):
    assert port_assets.manipulator_xml(task) == jax_assets.manipulator_xml(task)
  assert port_assets.humanoid_cmu_xml() == jax_assets.humanoid_cmu_xml()
  assert (port_assets.point_mass_device_xml()
          == jax_dd._point_mass_device_xml())


@pytest.mark.parametrize("source", ["committed", "port_extractor"])
@pytest.mark.parametrize("name", list(DMC_VARIANTS))
def test_dmc_model_data_equals_jax_extraction(name, source):
  """Each dm_control variant, committed or extracted by the port from its
  copy of the replica, equals the JAX class's model field by field."""
  cls, task = DMC_VARIANTS[name]
  cfg = types.SimpleNamespace(task_name=task, frame_skip=1)
  want = getattr(jax_dd, cls).mdl(cfg)
  if source == "committed":
    got = dm.read_model(dm.DMC_MODELS_DIR / f"{name}.npz")
    _assert_models_equal(dm.load_dmc_model(name), want, f"{name} loaded")
  else:
    got = dm.extract_model_string(port_assets.DMC_XMLS[name])
  _assert_models_equal(got, want, f"{name} {source}")
