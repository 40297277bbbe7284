"""The port's on-device MuJoCo models as data: the committed ``.npz`` files
(``envpool_torch/envs/mujoco/models/``) and the port's own extractor equal
``envpool_tpu.envs.mujoco.device_engine.extract_model`` field by field and
exactly for the four contact-free gym models; models with contacts or free
joints are refused by the loader and the engine."""

import numpy as np
import pytest
import torch

mujoco = pytest.importorskip("mujoco")
pytest.importorskip("gymnasium")

from envpool_torch.envs.mujoco import device_engine as port_de  # noqa: E402
from envpool_torch.envs.mujoco import device_model as dm  # noqa: E402
from envpool_tpu.envs.mujoco import device_engine as jax_de  # noqa: E402

torch.set_num_threads(1)

MODELS = ["reacher.xml", "inverted_pendulum.xml",
          "inverted_double_pendulum.xml", "swimmer.xml"]
CONTACT_MODELS = [x for x in dm.GYM_DEVICE_XMLS if x not in MODELS]

FREE_BODY = (
  "<mujoco><worldbody>"
  '<body name="b" pos="0 0 1"><freejoint/>'
  '<geom name="g" type="sphere" size=".1" contype="0" conaffinity="0"/>'
  "</body></worldbody></mujoco>"
)


def _assert_models_equal(got, want, tag):
  assert got._fields == want._fields
  for name in want._fields:
    g, w = getattr(got, name), getattr(want, name)
    if isinstance(w, np.ndarray):
      assert isinstance(g, np.ndarray), (tag, name)
      assert g.dtype == w.dtype and g.shape == w.shape, (tag, name)
      np.testing.assert_array_equal(g, w, err_msg=f"{tag} {name}")
    elif name == "contacts":
      assert w is None and g is None, (tag, name)
    else:
      assert type(g) is type(w) and g == w, (tag, name, g, w)


@pytest.mark.parametrize("source", ["committed", "port_extractor"])
@pytest.mark.parametrize("xml", MODELS)
def test_model_data_equals_jax_extraction(xml, source):
  want = jax_de.extract_model(dm.gym_asset(xml))
  if source == "committed":
    got = dm.load_model(xml)
  else:
    got = dm.extract_model(dm.gym_asset(xml))
  _assert_models_equal(got, want, f"{xml} {source}")


@pytest.mark.parametrize("xml", CONTACT_MODELS)
def test_contact_models_recorded_and_refused(xml):
  """The port's extractor records contact rows exactly where the JAX
  package builds contact tables; the loader refuses those models."""
  want = jax_de.extract_model(dm.gym_asset(xml))
  got = dm.extract_model(dm.gym_asset(xml))
  assert want.contacts is not None and got.contacts is not None
  assert got.contacts[0] >= 1
  assert dm.refused_models()[xml] == "contacts: not yet ported"
  with pytest.raises(NotImplementedError, match="contacts: not yet ported"):
    dm.load_model(xml)


def test_loader_refuses_half_cheetah():
  with pytest.raises(NotImplementedError, match="contacts: not yet ported"):
    dm.load_model("half_cheetah.xml")


def test_engine_refuses_contacts_and_free_joints(tmp_path):
  cheetah = dm.extract_model(dm.gym_asset("half_cheetah.xml"))
  q = torch.zeros(2, cheetah.nq, dtype=torch.float64)
  with pytest.raises(NotImplementedError, match="contacts: not yet ported"):
    port_de.step_smooth(cheetah, q, torch.zeros(2, cheetah.nv, dtype=q.dtype),
                        torch.zeros(2, 6, dtype=q.dtype))
  path = tmp_path / "free.xml"
  path.write_text(FREE_BODY)
  free = dm.extract_model(str(path))
  assert free.contacts is None
  with pytest.raises(NotImplementedError, match="free joints: not yet ported"):
    dm.check_supported(free)
  with pytest.raises(NotImplementedError, match="free joints"):
    port_de.step_smooth(free, torch.zeros(1, free.nq, dtype=torch.float64),
                        torch.zeros(1, free.nv, dtype=torch.float64),
                        torch.zeros(1, 0, dtype=torch.float64))


def test_written_models_read_back_equal(tmp_path):
  """``--write`` regenerates what is committed (read back, not bytes: the
  zip container carries times)."""
  refused = dm.write_models(tmp_path)
  assert refused == dm.refused_models()
  for xml in MODELS:
    stem = xml[:-4]
    _assert_models_equal(dm.read_model(tmp_path / f"{stem}.npz"),
                         dm.load_model(xml), xml)
  assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
    p.name for p in dm.MODELS_DIR.iterdir()
  )
