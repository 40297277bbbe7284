"""The compiled rollout (``envpool_torch/core/graph.py``) on the CPU.

On the card ``graph.scan`` captures one step as a CUDA graph and replays it;
a graph cannot read a flag back to the host, so the step it captures must
make no host read and build no tensor from host data, except the predicate
reads of ``graph.cond`` and ``graph.while_loop``, which become conditional
nodes there. On the CPU the same body runs eagerly, so a guard
(``HostReadGuard``, a ``TorchFunctionMode``) can see every such call in it:
one id per device family goes through ``graph.scan`` under the guard, bit
for bit against the eager ``xla()`` loop, with a cap that ends every lane's
episode. ``chip_smoke.py`` phase 18 runs the capture itself on the card,
under ``torch.cuda.set_sync_debug_mode("error")``.

Against the JAX package, in one jitted program (the file's one compile):
``cond``, ``while_loop`` and ``fori_loop`` against ``jax.lax``'s on the same
inputs; CartPole-v1 through ``graph.scan`` against the ``examples/xla_step.py``
loop under ``jax.jit(lax.scan)``, rewards per step; Sokoban-v0 through
``graph.scan`` against a jitted ``lax.scan`` over the JAX pool's ``xla()``,
every field. And the PPO rollout through its scan against its steps run one
by one.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import envpool_torch
import envpool_tpu
from envpool_torch.core import graph, prng
from envpool_torch.core.graph import tree_map
from envpool_torch.models import MLPActorCritic
from envpool_torch.train import PPOConfig, make_ppo_train_step, ppo_init

# the suite runs in several worker processes that share the cores
torch.set_num_threads(1)

LEVELS_DIR = os.path.join(
  os.path.dirname(envpool_torch.__file__), "envs", "sokoban", "sample_levels"
)

# ------------------------------------------------------------------ the guard

_HOST_READS = {
  torch.Tensor.item, torch.Tensor.tolist, torch.Tensor.cpu, torch.Tensor.numpy,
  torch.Tensor.__bool__, torch.Tensor.__int__, torch.Tensor.__float__,
  torch.Tensor.__index__,
}
_INDEXING = {torch.Tensor.__getitem__, torch.Tensor.__setitem__}


def _from_host(func, args) -> bool:
  """A tensor built from host data: on the card a copy to the device."""
  if func is torch.from_numpy:
    return True
  if func in (torch.tensor, torch.as_tensor):
    return not (args and isinstance(args[0], torch.Tensor))
  if func is torch.Tensor.new_tensor:
    return not isinstance(args[1], torch.Tensor)
  if func in _INDEXING:
    index = args[1] if isinstance(args[1], tuple) else (args[1],)
    if any(isinstance(i, (list, np.ndarray)) for i in index):
      return True
    # a host scalar stored through a tensor index is copied to the device
    return (func is torch.Tensor.__setitem__ and not isinstance(args[2], torch.Tensor)
            and any(isinstance(i, torch.Tensor) for i in index))
  return False


class HostReadGuard(TorchFunctionMode):
  """Records each host read and each tensor built from host data (host
  lists and arrays used as indices too) made inside it, with the line of
  the port that made it; ``graph._host_pred``, the predicate read of an
  eager ``cond`` or ``while_loop``, is exempt."""

  def __init__(self) -> None:
    super().__init__()
    self.found = []

  def __torch_function__(self, func, types, args=(), kwargs=None):
    if func in _HOST_READS or _from_host(func, args):
      frame, where = sys._getframe(1), None
      while frame is not None:
        if frame.f_code is graph._host_pred.__code__:
          break
        path = frame.f_code.co_filename
        if where is None and "envpool_torch" in path and not path.endswith("graph.py"):
          where = f"{path.split('envpool_torch')[-1]}:{frame.f_lineno}"
        frame = frame.f_back
      else:
        self.found.append(f"{getattr(func, '__name__', func)} at {where}")
    return func(*args, **(kwargs or {}))


def test_guard_sees_reads_and_host_data_but_not_predicates():
  x = torch.arange(4)
  with HostReadGuard() as guard:
    x.sum().item()
    bool(x.any())
    torch.tensor([1, 2])
    torch.as_tensor(x)      # a tensor already: no copy
    x[[0, 2]]
    x[0:2]
    x.clone()[torch.tensor(1)] = 5
    x.clone()[1:] = 5
    graph.cond(x > 2, lambda v: v + 1, lambda v: v, x)
    graph.while_loop(lambda v: v < 3, lambda v: v + 1, x)
  assert [f.split(" at ")[0] for f in guard.found] == [
    "item", "__bool__", "tensor", "__getitem__", "tensor", "__setitem__"]


# --------------------------------------------------- one id of each family

N, STEPS, CAP = 4, 8, 3
FAMILIES = {
  "CartPole-v1": ("CartPole-v1", {}),
  "Sokoban-v0 random": ("Sokoban-v0", dict(levels_dir="", n_levels_to_load=16)),
  "Sokoban-v0 sequential": ("Sokoban-v0", dict(levels_dir=LEVELS_DIR,
                                               load_sequentially=True)),
  "CarRacing-v2": ("CarRacing-v2", {}),
  "Blackjack-v1": ("Blackjack-v1", {}),
  "MiniGrid-Empty-8x8-v0": ("MiniGrid-Empty-8x8-v0", {}),
  "PongJaxDemo-v5": ("PongJaxDemo-v5", {}),
  "LunarLander-v2": ("LunarLander-v2", {}),
  "BipedalWalkerHardcore-v3": ("BipedalWalkerHardcore-v3", {}),
  "InvertedPendulumJax-v4": ("InvertedPendulumJax-v4", {}),
  "HopperJax-v4": ("HopperJax-v4", {}),
  "PusherJax-v4": ("PusherJax-v4", {}),
  "CartpoleJaxBalance-v1": ("CartpoleJaxBalance-v1", {}),
}


def _actions(env, task_id: str, steps: int, n: int, seed: int) -> torch.Tensor:
  """Uniform actions in the id's action space (Sokoban's noop -1 too)."""
  spec = env.spec.action_array_spec["action"]
  rng = np.random.default_rng(seed)
  shape = (steps, n, *spec.shape[1:])
  if np.issubdtype(spec.dtype, np.integer):
    lo = -1 if task_id == "Sokoban-v0" else int(spec.minimum)
    a = rng.integers(lo, int(spec.maximum) + 1, shape)
  else:
    a = rng.uniform(spec.minimum, spec.maximum, shape)
  return torch.from_numpy(a.astype(spec.dtype))


def _assert_bit_equal(got, want, tag: str) -> None:
  def eq(g, w):
    np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=tag)
  tree_map(eq, got, want)


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_scan_body_reads_nothing_back(name):
  """``graph.scan`` of ``xla()``'s send under the guard: no host read, and
  every output field and the final pool state bit for bit against the same
  steps run one by one, where every lane ended an episode before the last
  step (the reset branch, the IF node on the card, ran)."""
  task_id, kw = FAMILIES[name]
  env = envpool_torch.make_gymnasium(
    task_id, num_envs=N, seed=3, device="cpu", max_episode_steps=CAP, **kw
  )
  env.reset()
  acts = _actions(env, task_id, STEPS, N, seed=7)
  handle, _, send, _ = env.xla()

  def body(carry):
    h, t = carry
    h = send(h, acts.index_select(0, t)[0])
    return (h, t + 1), h.out

  t0 = torch.zeros(1, dtype=torch.int64)
  # the eager steps first: they make the family's device constants once, as
  # the capture's warm-up does before anything is captured
  carry, rows = (handle, t0), []
  for _ in range(STEPS):
    carry, y = body(carry)
    rows.append(y)
  with HostReadGuard() as guard:
    (got_handle, _), got = graph.scan(body, (handle, t0), STEPS)
  assert guard.found == [], guard.found
  _assert_bit_equal(got, tree_map(lambda *r: torch.stack(r), *rows), name)
  _assert_bit_equal(got_handle.pool, carry[0].pool, f"{name} final state")
  done = got[env._state_keys.index("done")]
  assert bool(done[:-1].any(0).all()), f"{name}: a lane never ended an episode"


def test_masked_entry_points_read_nothing_back():
  """``send`` to a device ``env_id`` and a forced reset of a device
  ``env_id`` (the host API's partial reset) through ``graph.scan`` under
  the guard, bit for bit against the same calls one by one."""
  n, steps = 8, 6
  env = envpool_torch.make_gymnasium("CartPole-v1", num_envs=n, seed=2, device="cpu")
  env.reset()
  handle, _, send, _ = env.xla()
  half, quarter = torch.arange(0, n, 2), torch.arange(0, n, 4)
  acts = torch.from_numpy(np.random.default_rng(1).integers(0, 2, (steps, n // 2)).astype(np.int32))
  # the carry keeps its shapes: its out holds the masked batch from here on
  handle = send(handle, acts[0], env_id=half)

  def body(carry):
    h, t = carry
    h = send(h, acts.index_select(0, t)[0], env_id=half)
    pool, outs = env._advance_ids(h.pool, None, quarter, True)
    return (h._replace(pool=pool), t + 1), (h.out, tuple(outs))

  t0 = torch.zeros(1, dtype=torch.int64)
  carry, rows = (handle, t0), []
  for _ in range(steps):
    carry, y = body(carry)
    rows.append(y)
  with HostReadGuard() as guard:
    (got_handle, _), got = graph.scan(body, (handle, t0), steps)
  assert guard.found == [], guard.found
  _assert_bit_equal(got, tree_map(lambda *r: torch.stack(r), *rows), "masked")
  _assert_bit_equal(got_handle.pool, carry[0].pool, "masked final state")
  # the reset lanes restart at every step; the others step on
  elapsed = got[1][env._state_keys.index("elapsed_step")]
  assert bool((elapsed == 0).all())
  assert int(got[0][env._state_keys.index("elapsed_step")][-1, 1]) == steps + 1
  # a body that changes the carry's shapes is refused, as the capture does
  with pytest.raises(ValueError):
    graph.scan(lambda h: (send(h, acts[0], env_id=half), ()), env.xla()[0], 2)


# ------------------------------------------------------------ the scan alone

def test_captured_scan_on_the_cpu_runs_the_body_eagerly():
  """``(carry, ys)`` with ``ys`` stacked ``[length, ...]``; ``steps`` runs a
  prefix; the carry's structure is kept."""
  def body(c):
    return {"x": c["x"] * 2, "n": c["n"] + 1}, (c["x"].sum(), c["n"])

  sc = graph.CapturedScan(body, 5)
  c0 = {"x": torch.ones(3, dtype=torch.int64), "n": torch.zeros((), dtype=torch.int64)}
  c, (s, n) = sc(c0)
  assert torch.equal(c["x"], torch.full((3,), 32)) and int(c["n"]) == 5
  assert s.tolist() == [3, 6, 12, 24, 48] and n.tolist() == [0, 1, 2, 3, 4]
  c, (s, _) = sc(c0, steps=2)
  assert s.tolist() == [3, 6] and int(c["n"]) == 2
  with pytest.raises(ValueError):
    sc(c0, steps=6)
  with pytest.raises(ValueError):
    graph.CapturedScan(body, 0)


def test_predicates_must_be_bool():
  with pytest.raises(ValueError):
    graph._pred_bytes(torch.ones(3, dtype=torch.int32))
  assert bool(graph.set_conditional_plain(torch.tensor([False, True])))


@pytest.mark.parametrize("n", [15, 16, 17])
def test_pred_bytes_and_any_at_the_vector_edges(n):
  """Widths around one 16-byte load: the bytes go to the kernel as they
  are, and the plain version sees the first and the last lane."""
  for lane in (None, 0, n - 1):
    pred = torch.zeros(n, dtype=torch.bool)
    if lane is not None:
      pred[lane] = True
    got = graph._pred_bytes(pred)
    assert got.data_ptr() == pred.data_ptr() and got.numel() == n
    assert bool(graph.set_conditional_plain(got)) == (lane is not None)


def test_pred_bytes_keeps_an_unaligned_view():
  """``pred[1:]`` of 16385 stays a view one byte past its base (the kernel
  reads the unaligned head bytewise), and a 2-D predicate is flattened."""
  base = torch.zeros(16385, dtype=torch.bool)
  view = base[1:]
  got = graph._pred_bytes(view)
  assert got.data_ptr() == base.data_ptr() + 1 and got.numel() == 16384
  assert not bool(graph.set_conditional_plain(got))
  for lane in (1, 8001, 16384):
    base.zero_()
    base[lane] = True
    assert bool(graph.set_conditional_plain(graph._pred_bytes(view)))
  base[0], base[1:] = True, False
  assert not bool(graph.set_conditional_plain(graph._pred_bytes(view)))
  square = graph._pred_bytes(base[1:].reshape(128, 128))
  assert square.shape == (16384,)


# ------------------------------------------------------- against JAX, once

CP_ENVS, CP_STEPS = 32, 240
SK_ENVS, SK_STEPS = 8, 40
SK_KW = dict(num_envs=SK_ENVS, seed=5, levels_dir="", n_levels_to_load=16,
             min_episode_steps=5, max_episode_steps=12)
FLOW_LANES = 64


def _flow_inputs():
  rng = np.random.default_rng(3)
  x = rng.integers(-50, 50, FLOW_LANES).astype(np.int32)
  preds = np.stack([
    np.zeros(FLOW_LANES, bool), rng.random(FLOW_LANES) < 0.1,
    np.ones(FLOW_LANES, bool),
  ])
  start = rng.integers(1, 9, FLOW_LANES).astype(np.int32)
  return x, preds, start


def _cond_true(pred, x, lib):
  return lib.where(pred, x * 3 - 7, x)


def _while_body(x, lib):
  return lib.where(x < 1000, x * 3 + 1, x)


COUNTED = (1, 2, 3, 198)


def _counted_body(x, lib):
  return lib.where(x % 2 == 0, x // 2, 3 * x + 1)


@pytest.fixture(scope="module")
def jax_side():
  """Everything JAX computes in this file, as numpy, from one jit."""
  x, preds, start = _flow_inputs()
  cp = envpool_tpu.make_gymnasium("CartPole-v1", num_envs=CP_ENVS, seed=0)
  cp.reset()
  cp_handle, cp_recv, cp_send, _ = cp.xla()
  cp_keys = cp._state_keys
  sk = envpool_tpu.make_gymnasium("Sokoban-v0", **SK_KW)
  sk.reset()
  sk_handle, sk_recv, sk_send, _ = sk.xla()
  sk_acts = np.random.default_rng(11).integers(-1, 4, (SK_STEPS, SK_ENVS)).astype(np.int32)

  def program(cp_handle, sk_handle, sk_acts, x, preds, start):
    # examples/xla_step.py's rollout
    def cp_body(handle, _):
      handle, states = cp_recv(handle)
      action = (states[cp_keys.index("obs")][:, 2] > 0).astype(jnp.int32)
      handle = cp_send(handle, action)
      return handle, states[cp_keys.index("reward")]

    _, cp_rewards = jax.lax.scan(cp_body, cp_handle, None, length=CP_STEPS)

    def sk_body(handle, a):
      handle = sk_send(handle, a)
      return handle, sk_recv(handle)[1]

    sk_final, sk_outs = jax.lax.scan(sk_body, sk_handle, sk_acts)
    conds = [jax.lax.cond(jnp.any(p), lambda v, p=p: _cond_true(p, v, jnp),
                          lambda v: v, x) for p in preds]
    loop = jax.lax.while_loop(lambda v: jnp.any(v < 1000),
                              lambda v: _while_body(v, jnp), start)
    fori = jax.lax.fori_loop(0, 5, lambda i, v: v * 2 - i, start)
    counted = [jax.lax.fori_loop(0, n, lambda i, v: _counted_body(v, jnp), start)
               for n in COUNTED]
    return cp_rewards, sk_outs, sk_final.pool, conds, loop, fori, counted

  out = jax.jit(program)(cp_handle, sk_handle, sk_acts, x, preds, start)
  return jax.tree_util.tree_map(np.asarray, out), sk_acts, list(sk._state_keys)


def test_cond_while_loop_and_fori_loop_match_jax(jax_side):
  (_, _, _, conds, loop, fori, _), _, _ = jax_side
  x, preds, start = (torch.from_numpy(a) for a in _flow_inputs())
  for p, want in zip(preds, conds):
    got = graph.cond(p, lambda v, p=p: _cond_true(p, v, torch), lambda v: v, x)
    np.testing.assert_array_equal(got.numpy(), want)
  got = graph.while_loop(lambda v: v < 1000, lambda v: _while_body(v, torch), start)
  np.testing.assert_array_equal(got.numpy(), loop)
  count = iter(range(5))
  got = graph.fori_loop(5, lambda v: v * 2 - next(count), start)
  np.testing.assert_array_equal(got.numpy(), fori)


def _counted_while(n: int, body, x):
  """A WHILE node driven by the counted form's plain version: the handle
  is ``counter < n`` on entry (the counter is 0 there), then the plain
  version sets it at the end of every round."""
  counter = torch.zeros(1, dtype=torch.int32)
  more, rounds = bool(counter[0] < n), 0
  while more:
    x = body(x)
    counter, handle = graph.set_counted_plain(counter, n)
    more, rounds = bool(handle[0]), rounds + 1
  return x, counter, rounds


@pytest.mark.parametrize("n", COUNTED)
def test_counted_form_matches_jax_fori_loop(jax_side, n):
  """The counted form's plain version runs ``n`` rounds, leaves its counter
  at 0 for the next run of the node, and the loop equals
  ``jax.lax.fori_loop(0, n, ...)``; so does ``graph.fori_loop`` eagerly."""
  (_, _, _, _, _, _, counted), _, _ = jax_side
  want = counted[COUNTED.index(n)]
  start = torch.from_numpy(_flow_inputs()[2])
  body = lambda v: _counted_body(v, torch)  # noqa: E731
  got, counter, rounds = _counted_while(n, body, start)
  assert rounds == n and int(counter[0]) == 0
  np.testing.assert_array_equal(got.numpy(), want)
  again, counter, rounds = _counted_while(n, body, start)
  assert rounds == n and int(counter[0]) == 0
  np.testing.assert_array_equal(again.numpy(), want)
  np.testing.assert_array_equal(graph.fori_loop(n, body, start).numpy(), want)


def test_cartpole_scan_matches_the_jax_example(jax_side):
  """The xla_step example's loop: rewards per step bit for bit."""
  (cp_rewards, _, _, _, _, _, _), _, _ = jax_side
  env = envpool_torch.make_gymnasium("CartPole-v1", num_envs=CP_ENVS, seed=0, device="cpu")
  env.reset()
  handle, recv, send, _ = env.xla()
  keys = env._state_keys

  def body(handle):
    handle, states = recv(handle)
    action = (states[keys.index("obs")][:, 2] > 0).to(torch.int32)
    handle = send(handle, action)
    return handle, states[keys.index("reward")]

  _, rewards = graph.scan(body, handle, CP_STEPS)
  np.testing.assert_array_equal(rewards.numpy(), cp_rewards)
  # episodes ended and restarted inside the rollout
  assert (cp_rewards == 0).sum() > CP_ENVS


def test_sokoban_scan_matches_the_jitted_jax_scan(jax_side):
  """Random mode, noops included, every lane auto-resetting: every output
  field of every step and the final pool state bit for bit."""
  (_, sk_outs, sk_pool, _, _, _, _), acts, keys = jax_side
  env = envpool_torch.make_gymnasium("Sokoban-v0", device="cpu", **SK_KW)
  env.reset()
  handle, recv, send, _ = env.xla()
  a = torch.from_numpy(acts)

  def body(carry):
    h, t = carry
    h = send(h, a.index_select(0, t)[0])
    return (h, t + 1), recv(h)[1]

  (final, _), outs = graph.scan(body, (handle, torch.zeros(1, dtype=torch.int64)), SK_STEPS)
  assert list(env._state_keys) == keys
  for k, got, want in zip(keys, outs, sk_outs):
    np.testing.assert_array_equal(got.numpy(), want, err_msg=k)
  assert sk_outs[keys.index("done")].any(0).all()
  np.testing.assert_array_equal(final.pool.rng.numpy().astype(np.uint32), sk_pool.rng)
  np.testing.assert_array_equal(final.pool.elapsed.numpy(), sk_pool.elapsed)
  for k, v in sk_pool.env.items():
    np.testing.assert_array_equal(final.pool.env[k].numpy(), v, err_msg=k)


# ------------------------------------------------------------------ trainer

def test_ppo_rollout_through_scan_equals_its_steps():
  """``PPOTrainStep.rollout`` (``graph.CapturedScan``) against the rollout
  written out step by step: trajectory, handle, key and bootstrap value bit
  for bit, twice with the same scan (the parameter buffers refilled)."""
  pool = envpool_torch.make_gymnasium("CartPole-v1", num_envs=8, seed=1, device="cpu")
  net = MLPActorCritic(num_actions=2, hidden=(16, 16), dtype=torch.float32)
  cfg = PPOConfig(num_steps=12)
  state, tx = ppo_init(pool, net, cfg, seed=4)
  step = make_ppo_train_step(pool, net, cfg, tx)
  for _ in range(2):
    handle, key, traj, last_value = step.rollout(state)
    h, k, rows = state.handle, state.key, []
    with torch.no_grad():
      for _ in range(cfg.num_steps):
        _, states = step._recv(h)
        obs = states[step._obs]
        k, sub = prng.split(k, 2)
        action, logp, value = step._sample(state.params, obs, sub)
        h = step._send(h, action.to(torch.int32))
        _, nxt = step._recv(h)
        rows.append((obs, action, logp, value, nxt[step._rew], nxt[step._done]))
      _, want_value = step._apply(state.params, step._recv(h)[1][step._obs])
    for i, name in enumerate(("obs", "action", "logp", "value", "reward", "done")):
      np.testing.assert_array_equal(
        traj[name].numpy(), torch.stack([r[i] for r in rows]).numpy(), err_msg=name)
    _assert_bit_equal((handle.pool, key, last_value), (h.pool, k, want_value), "carry")
    state, _ = step.update(state, (handle, key, traj, last_value))
