"""The host tier's ``xla()`` inside the compiled loop, on the CPU.

The JAX package's ``HostEnvPool.xla()`` runs its host step through
``io_callback(..., ordered=True)``, so a ``jax.jit(lax.scan)`` over its
``send`` steps the host envs. The port's ``send`` runs the same host step
(``HostEnvPool._host_step``): on the CPU directly, on the card in stream
order through a host function, which ``graph.scan`` captures as a host
node (``chip_smoke.py`` phases 16 and 17 hold that capture against the
eager loop on the card). Here the port's ``graph.scan`` (eager on the CPU)
and one jitted JAX program (the file's one compile) step pools of the same
seed and actions: InvertedPendulum-v4, the Atari wrapper stack over
``tests/test_atari_stack.py``'s scripted emulator, and an async
InvertedPendulum-v4 pool whose every send goes to the ``env_id`` of the
batch it received (the masked path). Every field bit for bit: the same
numpy code over the same ``mj_step``. The JAX side runs with x64 on (its
float64 columns) inside ``_x64``, which restores the flag after it: the
suite's workers share a process between files.

And the bridge's host-API rule: after a send on the card, a host-API call
first waits for the device; inside a host step it does not, and an error
raised in a host step surfaces at the next host-API call.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import envpool_torch
import envpool_tpu
from envpool_torch.core import graph, host_pool
from envpool_torch.envs import atari as port_atari
from envpool_torch.envs.atari import atari_env as A
from envpool_tpu.envs import atari as jax_atari
from envpool_tpu.envs.atari import atari_env as JA

from _torch_host import uniform_actions
from test_atari_stack import FakeALE

torch.set_num_threads(1)

N, STEPS = 4, 12
ATARI_STEPS = 32  # past the scripted emulator's first game over
ASYNC = dict(num_envs=4, batch_size=2, num_threads=1)  # one worker: FIFO order


@contextlib.contextmanager
def _x64():
  """x64 for the JAX side, its host callbacks included. They run on XLA's
  threads, where the thread-local ``jax.enable_x64`` does not reach (an
  async pool's callback then returned float32 columns), so the process
  flag is set for the block and put back after it; a worker runs one test
  at a time."""
  old = jax.config.jax_enable_x64
  jax.config.update("jax_enable_x64", True)
  try:
    yield
  finally:
    jax.config.update("jax_enable_x64", old)


def _atari_spec(module, **kw):
  return module.AtariEnvSpec(module.AtariEnvSpec.gen_config(**kw))


def _pools(package):
  """(pendulum, atari, async pendulum) of one package at the same seeds."""
  if package is envpool_torch:
    make = lambda t, **kw: envpool_torch.make_gymnasium(t, device="cpu", **kw)  # noqa: E731
    atari = port_atari.AtariGymnasiumEnvPool(
      _atari_spec(port_atari, num_envs=N, seed=2, num_threads=2), "cpu")
  else:
    make = envpool_tpu.make_gymnasium
    atari = jax_atari.AtariGymnasiumEnvPool(
      _atari_spec(jax_atari, num_envs=N, seed=2, num_threads=2))
  return (make("InvertedPendulum-v4", num_envs=N, seed=5), atari,
          make("InvertedPendulum-v4", seed=6, **ASYNC))


def _first_batch(pool):
  """An async pool's reset and first received batch (the masked loop's
  first outputs and env ids)."""
  pool.async_reset()
  return pool._recv()


@pytest.fixture(scope="module")
def runs():
  """Every output of each pool's loop, port and JAX, as numpy."""
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(A, "_make_ale", lambda task, seed, rap: FakeALE())
    mp.setattr(JA, "_make_ale", lambda task, seed, rap: FakeALE())
    port = _pools(envpool_torch)
    with _x64():  # the JAX pools' float64 columns
      want = _pools(envpool_tpu)
    keys = port[0].spec._state_keys
    id_col = keys.index("info:env_id")
    acts = (uniform_actions(port[0].spec, N, STEPS, seed=7),
            np.random.default_rng(8).integers(0, 4, (ATARI_STEPS, N)).astype(np.int32),
            uniform_actions(port[0].spec, ASYNC["batch_size"], STEPS, seed=9))
    firsts = (_first_batch(port[2]), _first_batch(want[2]))
    assert [c.dtype for c in firsts[0]] == [c.dtype for c in firsts[1]]

    # the port: graph.scan over xla()'s send, eager on the CPU
    got = []
    for pool, act, first in zip(port, acts, (None, None, firsts[0])):
      handle, recv, send, _ = pool.xla()
      if first is not None:
        handle = (handle[0], tuple(torch.from_numpy(c) for c in first))
      a = torch.from_numpy(act)
      masked = first is not None

      def body(carry, send=send, recv=recv, a=a, masked=masked):
        h, t = carry
        ids = h[1][id_col] if masked else None
        h = send(h, a.index_select(0, t)[0], ids)
        return (h, t + 1), recv(h)[1]

      (final, _), outs = graph.scan(body, (handle, torch.zeros(1, dtype=torch.int64)),
                                    len(act))
      assert int(final[0]) == len(act)
      got.append([o.numpy() for o in outs])

    # the JAX package: one jitted program of three scans
    with _x64():
      fns = [p.xla() for p in want]
      handles = [f[0] for f in fns]
      handles[2] = (handles[2][0], tuple(jnp.asarray(c) for c in firsts[1]))

      def program(handles, acts):
        outs = []
        for (_, recv, send, _), h, a, masked in zip(fns, handles, acts,
                                                    (False, False, True)):
          def body(h, x, send=send, recv=recv, masked=masked):
            h = send(h, x, h[1][id_col] if masked else None)
            return h, recv(h)[1]

          outs.append(jax.lax.scan(body, h, a)[1])
        return outs

      ref = jax.tree.map(np.asarray, jax.jit(program)(tuple(handles), acts))
  return keys, got, ref


@pytest.mark.parametrize("case", [0, 1, 2], ids=["InvertedPendulum-v4", "atari",
                                                 "async-masked"])
def test_scan_of_host_steps_matches_jax(runs, case):
  keys, got, ref = runs
  for k, g, w in zip(keys, got[case], ref[case]):
    assert g.dtype == w.dtype, (k, g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w, err_msg=k)
  done = got[case][keys.index("done")]
  assert done.any(), "no episode ended inside the loop"
  if case == 2:
    # every send went to the batch received before it
    ids = got[case][keys.index("info:env_id")]
    assert sorted(np.unique(ids).tolist()) == list(range(ASYNC["num_envs"]))


def test_host_api_waits_for_queued_host_steps(monkeypatch):
  """After a send has queued host steps on the card, every host-API call
  synchronises the pool's device first (the wait releases the GIL that a
  host step takes); a host step's own calls do not wait."""
  env = envpool_torch.make_gymnasium("InvertedPendulum-v4", num_envs=2, seed=0,
                                     device="cpu")
  waits = []
  monkeypatch.setattr(torch.cuda, "synchronize", lambda d=None: waits.append(d))
  env.reset()
  assert waits == []  # nothing queued yet
  bridge = host_pool._Bridge.__new__(host_pool._Bridge)
  bridge.queued, bridge.errors = True, []
  env._bridge = bridge
  env.step(np.zeros((2, 1)))
  assert waits == [env.device] * 2  # send, then recv
  host_pool._in_host_step.active = True
  try:
    env._host_step({"action": np.zeros((2, 1))}, np.arange(2, dtype=np.int32))
  finally:
    host_pool._in_host_step.active = False
  assert len(waits) == 2


def test_host_step_error_surfaces_at_the_next_call():
  """A host function cannot raise into the stream: its error is kept and
  raised by the next host-API call, once."""
  env = envpool_torch.make_gymnasium("InvertedPendulum-v4", num_envs=2, seed=0,
                                     device="cpu")
  bridge = host_pool._Bridge.__new__(host_pool._Bridge)
  bridge.queued, bridge.errors = False, []
  env._bridge = bridge
  outs = [np.empty((2, *s.shape[1:]), s.dtype) for s in env.spec._state_spec]
  env._run_host_step({"action": np.zeros((2, 1))}, np.array([0, 7], np.int32), outs)
  assert len(bridge.errors) == 1
  with pytest.raises(RuntimeError, match="host step of xla"):
    env.reset()
  assert bridge.errors == []


def test_cpu_send_counts_and_keeps_outputs():
  """The handle's count is an int32 tensor on the pool's device, as the
  JAX package's is; outputs already handed out are not written again."""
  env = envpool_torch.make_gymnasium("InvertedPendulum-v4", num_envs=2, seed=0,
                                     device="cpu")
  handle, _, _, step = env.xla()
  assert handle[0].dtype == torch.int32 and int(handle[0]) == 0
  handle, first = step(handle, torch.zeros((2, 1), dtype=torch.float64))
  kept = [o.clone() for o in first]
  handle, _ = step(handle, torch.ones((2, 1), dtype=torch.float64))
  assert int(handle[0]) == 2
  for a, b in zip(first, kept):
    assert torch.equal(a, b)


def test_failed_host_step_stops_the_pool_and_a_graph_raises_it(monkeypatch):
  """After a host step failed, later host steps of the pool do nothing
  (their outputs stay as they were) until the error is raised; a graph
  that holds host nodes waits for its stream after a replay and raises
  the error through the check its host functions registered (the card's
  ``CapturedScan.replay`` and ``CapturedCall.__call__`` end so)."""
  env = envpool_torch.make_gymnasium("InvertedPendulum-v4", num_envs=2, seed=0,
                                     device="cpu")
  bridge = host_pool._Bridge.__new__(host_pool._Bridge)
  bridge.queued, bridge.errors = False, []
  env._bridge = bridge
  outs = [np.zeros((2, *shp), dt) for _, shp, dt in env._layout]
  act = {"action": np.zeros((2, 1))}
  env._run_host_step(act, np.array([0, 7], np.int32), outs)
  assert len(bridge.errors) == 1
  env._run_host_step(act, np.arange(2, dtype=np.int32), outs)
  assert all(not o.any() for o in outs) and env._inflight == 0
  waits = []
  monkeypatch.setattr(graph, "_wait_stream", waits.append)
  captured = graph.CapturedCall(lambda x: x)
  captured._raise_host_errors()  # no host node: no wait
  assert waits == []
  captured.host_nodes, captured._device = 1, torch.device("cpu")
  captured._host_checks = [bridge.raise_error]
  with pytest.raises(RuntimeError, match="host step of xla"):
    captured._raise_host_errors()
  assert waits == [torch.device("cpu")] and bridge.errors == []
  captured._raise_host_errors()  # raised once
  env._run_host_step(act, np.arange(2, dtype=np.int32), outs)  # steps again
  assert bridge.errors == [] and outs[env._state_keys.index("obs")].any()
