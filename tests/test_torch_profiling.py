"""The port's profiling helpers (``envpool_torch/utils/profiling.py``):
``StepTimer`` counts and keys as the JAX package's class, and ``trace``
writes a Chrome trace that names the CPU ops of a few pool steps."""

import json
import time

import numpy as np

import envpool_torch
from envpool_torch.utils import StepTimer, trace
from envpool_tpu.utils import StepTimer as JaxStepTimer


def test_step_timer_counts_and_keys():
  timers = (StepTimer(), JaxStepTimer())
  for timer in timers:
    for _ in range(3):
      with timer.send():
        time.sleep(0.001)
    with timer.recv():
      pass
  got, want = (t.summary() for t in timers)
  assert list(got) == list(want)
  assert got["n_send"] == 3 and got["n_recv"] == 1
  assert got["dur_send_s"] >= 0.003 and got["avg_send_ms"] >= 1.0
  assert StepTimer().summary()["avg_recv_ms"] == 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
  env = envpool_torch.make_gymnasium("CartPole-v1", num_envs=4, seed=0, device="cpu")
  env.reset()
  with trace(str(tmp_path)) as prof:
    for _ in range(3):
      env.step(np.zeros(4, np.int32))
  files = list(tmp_path.glob("trace_*.json"))
  assert len(files) == 1
  events = json.loads(files[0].read_text())["traceEvents"]
  names = {e.get("name", "") for e in events}
  assert any(n.startswith("aten::") for n in names), sorted(names)[:20]
  assert any(e.key.startswith("aten::") for e in prof.key_averages())
