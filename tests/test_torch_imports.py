"""The port stands alone: it imports without jax, flax and optax (and
without optree, gymnasium, dm_env, Box2D, mujoco and ale_py), lists all of
the JAX package's ids in its order (the host tier's too: making a MuJoCo
or dm_control host id then raises an ImportError that names mujoco), every
device family steps and one PPO iteration and the mesh dry run run so, the
mesh layer, the utilities, the host families and the examples load no
module of jax or the JAX package even where jax is installed, no file of
it imports jax, flax, optax, Box2D or envpool_tpu, and mujoco, gymnasium
and ale_py are imported only inside functions. Its ids are the JAX
package's, in its order; the procgen and vizdoom families are skipped only
where their wheel itself is missing."""

import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent

_CHILD = """
import json
import os
import sys
for name in ("jax", "jaxlib", "flax", "optax", "optree", "gymnasium", "dm_env",
             "envpool_tpu", "Box2D", "mujoco", "ale_py"):
  sys.modules[name] = None
import numpy as np
import torch
torch.set_num_threads(1)  # the eager MuJoCo steps are many tiny ops
import envpool_torch
import envpool_torch.models
import envpool_torch.ops
import envpool_torch.train
import envpool_torch.core.host_pool
import envpool_torch.envs.atari.atari_env
import envpool_torch.envs.mujoco.dmc.domains
import envpool_torch.envs.mujoco.gym_tasks
assert envpool_torch.list_all_envs() == json.loads(os.environ["JAX_IDS"]), \
  envpool_torch.list_all_envs()
# the host tier's ids are listed; making one needs its emulator library
for task_id in ("Hopper-v4", "CheetahRun-v1"):
  try:
    envpool_torch.make_gymnasium(task_id, num_envs=2, device="cpu")
    raise AssertionError(task_id + " built without mujoco")
  except ImportError as e:
    assert "mujoco" in str(e), (task_id, e)
for task_id, kw, obs_shape, action in (
  ("CarRacing-v2", dict(n_tracks=1), (2, 96, 96, 3), np.zeros((2, 3), np.float32)),
  ("Sokoban-v0", dict(n_levels_to_load=4), (2, 3, 10, 10), np.zeros(2, np.int32)),
  ("CartPole-v1", {}, (2, 4), np.zeros(2, np.int32)),
  ("Pendulum-v1", {}, (2, 3), np.zeros((2, 1), np.float32)),
  ("Acrobot-v1", {}, (2, 6), np.zeros(2, np.int32)),
  ("MountainCar-v0", {}, (2, 2), np.zeros(2, np.int32)),
  ("MountainCarContinuous-v0", {}, (2, 2), np.zeros((2, 1), np.float32)),
  ("Dummy-v0", {}, (2, 2), np.zeros(2, np.int32)),
  ("Catch-v0", {}, (2, 10, 5), np.zeros(2, np.int32)),
  ("FrozenLake-v1", {}, (2,), np.zeros(2, np.int32)),
  ("Taxi-v3", {}, (2,), np.zeros(2, np.int32)),
  ("NChain-v0", {}, (2,), np.zeros(2, np.int32)),
  ("CliffWalking-v0", {}, (2,), np.zeros(2, np.int32)),
  ("Blackjack-v1", {}, (2, 3), np.zeros(2, np.int32)),
  ("MiniGrid-Empty-Random-6x6-v0", {}, (2, 7, 7, 3), np.zeros(2, np.int32)),
  ("PongJaxDemo-v5", {}, (2, 4, 84, 84), np.zeros(2, np.int32)),
  ("LunarLander-v2", {}, (2, 8), np.zeros(2, np.int32)),
  ("LunarLanderContinuous-v2", {}, (2, 8), np.zeros((2, 2), np.float32)),
  ("BipedalWalker-v3", {}, (2, 24), np.zeros((2, 4), np.float32)),
  ("BipedalWalkerHardcore-v3", {}, (2, 24), np.zeros((2, 4), np.float32)),
  ("ReacherJax-v4", {}, (2, 11), np.zeros((2, 2), np.float32)),
  ("InvertedPendulumJax-v4", {}, (2, 4), np.zeros((2, 1), np.float32)),
  ("InvertedDoublePendulumJax-v4", {}, (2, 11), np.zeros((2, 1), np.float32)),
  ("SwimmerJax-v4", {}, (2, 8), np.zeros((2, 2), np.float32)),
  ("HalfCheetahJax-v4", {}, (2, 17), np.zeros((2, 6), np.float32)),
  ("HopperJax-v4", {}, (2, 11), np.zeros((2, 3), np.float32)),
  ("Walker2dJax-v4", {}, (2, 17), np.zeros((2, 6), np.float32)),
  ("AntJax-v4", {}, (2, 27), np.zeros((2, 8), np.float32)),
  ("HumanoidJax-v4", {}, (2, 376), np.zeros((2, 17), np.float32)),
  ("HumanoidStandupJax-v4", {}, (2, 376), np.zeros((2, 17), np.float32)),
  ("PusherJax-v4", {}, (2, 23), np.zeros((2, 7), np.float32)),
):
  env = envpool_torch.make_gymnasium(
    task_id, num_envs=2, seed=0, device="cpu", **kw
  )
  obs, info = env.reset()
  obs = obs.get("raw", obs.get("image")) if isinstance(obs, dict) else obs
  assert obs.shape == obs_shape, (task_id, obs.shape)
  obs, rew, term, trunc, info = env.step(action)
  assert info["elapsed_step"].tolist() == [1, 1], task_id
  assert not task_id.endswith("Jax-v4") or np.isfinite(obs).all(), task_id
# one id of each dm_control domain: every observation finite
for task_id, n_act in (
  ("PendulumJaxSwingup-v1", 1), ("CartpoleJaxThreePoles-v1", 1),
  ("AcrobotJaxSwingup-v1", 1), ("ReacherJaxHard-v1", 2),
  ("PointMassJaxHard-v1", 2), ("SwimmerJaxSwimmer6-v1", 5),
  ("FishJaxSwim-v1", 5), ("FingerJaxTurnHard-v1", 2), ("HopperJaxHop-v1", 4),
  ("WalkerJaxRun-v1", 6), ("CheetahJaxRun-v1", 6),
  ("BallInCupJaxCatch-v1", 2), ("HumanoidJaxRun-v1", 21),
  ("ManipulatorJaxBringBall-v1", 5), ("ManipulatorJaxInsertPeg-v1", 5),
  ("HumanoidCMUJaxRun-v1", 56),
):
  env = envpool_torch.make_gymnasium(task_id, num_envs=2, seed=0, device="cpu")
  env.reset()
  obs, rew, term, trunc, info = env.step(np.zeros((2, n_act), np.float32))
  assert info["elapsed_step"].tolist() == [1, 1], task_id
  assert all(np.isfinite(x).all() for x in obs.values()), task_id
from envpool_torch.models import SokobanCNN
from envpool_torch.train import PPOConfig, make_ppo_train_step, ppo_init
pool = envpool_torch.make_gymnasium(
  "Sokoban-v0", num_envs=2, seed=0, device="cpu", n_levels_to_load=4
)
net = SokobanCNN(channels=(4, 4, 4))
cfg = PPOConfig(num_steps=2, num_minibatches=2)
state, tx = ppo_init(pool, net, cfg)
state, metrics = make_ppo_train_step(pool, net, cfg, tx)(state)
assert sorted(metrics) == ["entropy", "mean_reward", "pg_loss", "v_loss"]
import envpool_torch.parallel
import envpool_torch.parallel.dryrun
import envpool_torch.utils
envpool_torch.parallel.dryrun.dryrun_multichip(4, device="cpu")
# the last host families: vizdoom's pure action set without the wheel,
# its env classes refused; procgen under a scripted wheel; the examples
import envpool_torch.envs.vizdoom
import envpool_torch.envs.vizdoom.vizdoom_env
assert envpool_torch.envs.vizdoom.action_set.build_action_set(
  ["ATTACK", "MOVE_RIGHT", "MOVE_LEFT"]).shape == (6, 3)
try:
  envpool_torch.envs.vizdoom.VizdoomEnvSpec
  raise AssertionError("VizdoomEnvSpec without vizdoom")
except ImportError as e:
  assert "vizdoom" in str(e), e
import types
sys.modules["procgen"] = types.ModuleType("procgen")
import envpool_torch.envs.procgen
assert envpool_torch.envs.procgen.ProcgenEnvSpec
import envpool_torch.examples
import envpool_torch.examples.async_loop
import envpool_torch.examples.ppo_mujoco
import envpool_torch.examples.ppo_sokoban
import envpool_torch.examples.xla_step
assert all(sys.modules[m] is None
           for m in ("jax", "flax", "optax", "envpool_tpu", "mujoco", "gymnasium",
                     "ale_py"))
print("ok")
"""


def test_imports_without_jax():
  import envpool_tpu

  # the ALE ids are registered only where ale_py is installed, and the
  # child runs without it
  ids = [t for t in envpool_tpu.list_all_envs()
         if envpool_tpu.registration.registry.specs[t][1] != "AtariEnvSpec"]
  env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_IDS=json.dumps(ids))
  res = subprocess.run(
    [sys.executable, "-c", _CHILD], cwd=ROOT, env=env, capture_output=True,
    text=True, timeout=240,
  )
  assert res.returncode == 0, res.stderr
  assert res.stdout.strip().endswith("ok")


_MESH_CHILD = """
import sys
import envpool_torch.parallel
import envpool_torch.parallel.dryrun
import envpool_torch.utils
import envpool_torch.envs.atari
import envpool_torch.envs.mujoco.dmc
import envpool_torch.envs.vizdoom
import envpool_torch.envs.vizdoom.vizdoom_env
import types
sys.modules["procgen"] = types.ModuleType("procgen")
import envpool_torch.envs.procgen
import envpool_torch.examples.async_loop
import envpool_torch.examples.ppo_mujoco
import envpool_torch.examples.ppo_sokoban
import envpool_torch.examples.xla_step
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "envpool_tpu"))
assert not bad, bad
print("ok")
"""


def test_mesh_and_utils_pull_in_no_jax():
  """With jax installed and importable, importing the mesh layer, the
  dry run, the utilities, the host tier's families (procgen under a
  scripted wheel) and the examples loads no module of jax or of the JAX
  package."""
  env = dict(os.environ, PYTHONPATH=str(ROOT))
  res = subprocess.run(
    [sys.executable, "-c", _MESH_CHILD], cwd=ROOT, env=env,
    capture_output=True, text=True, timeout=120,
  )
  assert res.returncode == 0, res.stderr
  assert res.stdout.strip().endswith("ok")


def _imported_roots(path: Path):
  tree = ast.parse(path.read_text(), filename=str(path))
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      for alias in node.names:
        yield alias.name.split(".")[0]
    elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
      yield node.module.split(".")[0]


def test_no_jax_or_reference_imports():
  files = sorted((ROOT / "envpool_torch").rglob("*.py"))
  files.append(ROOT / "chip_smoke.py")
  assert len(files) > 10
  for path in files:
    roots = set(_imported_roots(path))
    assert not roots & {
      "jax", "jaxlib", "flax", "optax", "envpool_tpu", "optree", "Box2D"
    }, path


def _imported_names(path: Path):
  """Every dotted name an import statement of ``path`` binds or reads: the
  module, and for ``from m import a`` also ``m.a``."""
  tree = ast.parse(path.read_text(), filename=str(path))
  for node in ast.walk(tree):
    if isinstance(node, ast.Import):
      for alias in node.names:
        yield alias.name
    elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
      yield node.module
      for alias in node.names:
        yield f"{node.module}.{alias.name}"


def test_no_jax_named_module_anywhere_in_an_import():
  """No import of the port or of ``chip_smoke.py`` names a jax module at
  any depth of its dotted path (``acme.agents.jax`` imports jax, yet its
  top-level package is ``acme``)."""
  files = sorted((ROOT / "envpool_torch").rglob("*.py"))
  files.append(ROOT / "chip_smoke.py")
  for path in files:
    for name in _imported_names(path):
      parts = set(name.split("."))
      assert not parts & {"jax", "jaxlib", "flax", "optax", "envpool_tpu"}, (path, name)


def _module_level_imports(path: Path):
  """Roots of the imports outside any function body."""
  tree = ast.parse(path.read_text(), filename=str(path))
  stack = list(tree.body)
  while stack:
    node = stack.pop()
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
      continue
    if isinstance(node, ast.Import):
      for alias in node.names:
        yield alias.name.split(".")[0]
    elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
      yield node.module.split(".")[0]
    stack.extend(ast.iter_child_nodes(node))


def test_mujoco_imported_only_inside_functions():
  """The device MuJoCo family runs from its committed model data:
  ``mujoco`` and ``gymnasium`` are imported only inside functions (the
  extractor's, which regenerate that data, and the host tier's, which build
  its envs), and so is ``ale_py``."""
  files = sorted((ROOT / "envpool_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
  for path in files:
    assert not set(_module_level_imports(path)) & {
      "mujoco", "gymnasium", "ale_py"
    }, path
  extractor = ROOT / "envpool_torch" / "envs" / "mujoco" / "device_model.py"
  assert "mujoco" in set(_imported_roots(extractor))


def test_device_ids_are_the_jax_packages():
  """Every on-device id of the JAX package (the ``...Jax...`` ids: the
  Pong demo, the gym MuJoCo ``-Jax-v4`` and the dm_control ``-Jax-v1``
  tiers) is registered in the port, in the same order; and so is every
  other id: the port lists the JAX package's ids, in its order."""
  import envpool_torch
  import envpool_tpu

  def device(ids):
    return [i for i in ids if "Jax" in i]
  want = device(envpool_tpu.list_all_envs())
  assert len(want) == 49
  assert device(envpool_torch.list_all_envs()) == want
  assert envpool_torch.list_all_envs() == envpool_tpu.list_all_envs()


_BROKEN_CHILD = """
import importlib.abc
import sys
case = sys.argv[1]


class Broken(importlib.abc.MetaPathFinder):
  def find_spec(self, name, path=None, target=None):
    if case == "wheel_fails" and name == "procgen":
      raise ImportError("procgen's native library failed to load")
    if case == "wheel_dependency_missing" and name == "vizdoom":
      raise ModuleNotFoundError("No module named 'vizdoom_native'",
                                name="vizdoom_native")
    return None


sys.meta_path.insert(0, Broken())
if case == "port_module_missing":
  sys.modules["envpool_torch.envs.procgen.registration"] = None
try:
  import envpool_torch
except ImportError as e:
  print(type(e).__name__, getattr(e, "name", None), e)
  sys.exit(0)
print("swallowed")
sys.exit(1)
"""


@pytest.mark.parametrize("case,raised", [
  ("wheel_fails", "ImportError None"),
  ("wheel_dependency_missing", "ModuleNotFoundError vizdoom_native"),
  ("port_module_missing",
   "ModuleNotFoundError envpool_torch.envs.procgen.registration"),
])
def test_entry_skips_only_a_missing_wheel(case, raised):
  """``entry.py`` skips the procgen and vizdoom families only when the
  wheel itself is missing: a wheel that fails to load, a missing module
  the wheel needs, or a missing module of the port stops the import of
  ``envpool_torch`` with that error."""
  env = dict(os.environ, PYTHONPATH=str(ROOT))
  res = subprocess.run(
    [sys.executable, "-c", _BROKEN_CHILD, case], cwd=ROOT, env=env,
    capture_output=True, text=True, timeout=120,
  )
  assert res.returncode == 0, res.stdout + res.stderr
  assert res.stdout.startswith(raised), res.stdout
