"""The port's image ops and on-device Atari demo (CPU).

- ``resize_area``, ``grayscale``, ``max_last_two`` and ``stack_push``
  against ``envpool_tpu.ops``: grayscale bit for bit on every colour the
  demo draws and on random frames; the resize to the JAX package's own
  rule against numpy (``tests/test_atari_device_demo.py``): at most 1 level
  off, on under 0.5% of the pixels (XLA-CPU and the CPU's BLAS sum the
  weights in other orders, so a pixel sum on the .5 line may round either
  way);
- PongJaxDemo-v5 against ``envpool_tpu`` over 200 steps with auto-resets:
  game state, score, reward, done and every integer field bit for bit,
  observations to the resize rule; the 21-point end from a loaded state;
- twins of ``tests/test_ops.py`` and ``tests/test_atari_device_demo.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import envpool_torch
import envpool_tpu
from envpool_torch.envs.atari import PongDemoEnv, atari_device_demo as demo
from envpool_torch.ops import grayscale, image, max_last_two, resize_area, stack_push
from envpool_tpu.envs.atari import atari_device_demo as jax_demo
from envpool_tpu.ops import image as jax_image

torch.set_num_threads(1)


def _port(task_id="PongJaxDemo-v5", **kw):
  return envpool_torch.make_gymnasium(task_id, device="cpu", **kw)


def assert_close_frames(got, want, tag=""):
  """At most 1 level off, on under 0.5% of the pixels."""
  d = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
  assert d.max() <= 1, (tag, d.max())
  assert (d > 0).mean() < 0.005, (tag, (d > 0).mean())
  return int((d > 0).sum())


# ------------------------------------------------------------------ ops


def test_area_weights_equal_jax_package():
  for n_in, n_out in ((210, 84), (160, 84), (168, 84), (7, 3)):
    np.testing.assert_array_equal(
      image._area_weights(n_in, n_out), jax_image._area_weights(n_in, n_out)
    )


def test_grayscale_bit_exact():
  rng = np.random.default_rng(2)
  frames = rng.integers(0, 256, (2, 210, 160, 3), dtype=np.uint8)
  want = np.asarray(jax.jit(jax_image.grayscale)(jnp.asarray(frames)))
  np.testing.assert_array_equal(grayscale(torch.from_numpy(frames)).numpy(), want)
  f32 = frames[0].astype(np.float32)
  np.testing.assert_array_equal(
    grayscale(torch.from_numpy(f32)).numpy(),
    np.asarray(jax.jit(jax_image.grayscale)(jnp.asarray(f32))),
  )
  # the demo's palette, and colours whose float sums lie on the .5 line
  # (found by sweeping all 2^24: float32 products and sums without the
  # fused multiply-adds round them the other way)
  colours = np.concatenate([demo.PALETTE, [[4, 40, 16], [5, 233, 81], [255, 203, 71]]]).astype(np.uint8)
  np.testing.assert_array_equal(
    grayscale(torch.from_numpy(colours)).numpy(), np.asarray(jax_image.grayscale(jnp.asarray(colours)))
  )


@pytest.mark.parametrize("gray", [True, False])
def test_resize_against_jax_package(gray):
  rng = np.random.default_rng(0)
  f0, f1 = rng.integers(0, 256, (2, 210, 160, 3), dtype=np.uint8)
  if gray:
    f0, f1 = (np.array(jax_image.grayscale(jnp.asarray(f)))[None] for f in (f0, f1))
  else:
    f0, f1 = np.moveaxis(f0, -1, 0), np.moveaxis(f1, -1, 0)
  want = jax.jit(lambda a, b: jax_image.resize_area(jax_image.max_last_two(a, b), (84, 84)))(
    jnp.asarray(f0), jnp.asarray(f1)
  )
  got = resize_area(max_last_two(torch.from_numpy(f0), torch.from_numpy(f1)), (84, 84))
  assert got.dtype == torch.uint8 and got.shape == want.shape
  assert_close_frames(got.numpy(), want)
  # the float path (no rounding) to float32 rounding
  x = rng.uniform(0, 255, (3, 210, 160)).astype(np.float32)
  np.testing.assert_allclose(
    resize_area(torch.from_numpy(x), (84, 84)).numpy(),
    np.asarray(jax_image.resize_area(jnp.asarray(x), (84, 84))), rtol=1e-5, atol=1e-4,
  )


def test_stack_push_batched_axis():
  stack = torch.arange(2 * 4 * 3).reshape(2, 4, 3)
  frame = torch.full((2, 3), -1)
  out = stack_push(stack, frame, dim=1)
  np.testing.assert_array_equal(out[:, :3].numpy(), stack[:, 1:].numpy())
  np.testing.assert_array_equal(out[:, 3].numpy(), -1)
  want = np.asarray(jax_image.stack_push(jnp.asarray(stack[0].numpy()), jnp.asarray(frame[0].numpy())))
  np.testing.assert_array_equal(stack_push(stack[0], frame[0]).numpy(), want)


# -------------------------------------------------------------- the demo


def test_palette_render_equals_jax_order():
  """The env's colour-index render through the grey or RGB palette gives
  the bytes of the JAX package's ``render_frame`` (RGB, then grayscale),
  with the ball near every edge of the play area."""
  rng = np.random.default_rng(1)
  n = 64
  ay = rng.integers(demo.TOP, demo.BOT - demo.PAD_H + 1, n).astype(np.int32)
  ey = rng.integers(demo.TOP, demo.BOT - demo.PAD_H + 1, n).astype(np.int32)
  bx = rng.uniform(-1, 160, n).astype(np.float32)
  by = rng.uniform(30, 196, n).astype(np.float32)
  bx[:4] = [0.5, 1.5, 157.5, 158.5]    # round half to even
  args = [torch.from_numpy(v) for v in (ay, ey, bx, by)]
  for gray in (True, False):
    want = jax.jit(jax.vmap(lambda *a: jax_demo.render_frame(*a, gray)))(
      *(jnp.asarray(v) for v in (ay, ey, bx, by))
    )
    np.testing.assert_array_equal(demo.render_frame(*args, gray).numpy(), np.asarray(want))
    cfg = envpool_torch.make_spec("PongJaxDemo-v5", gray_scale=gray).config
    st = dict(zip(("ay", "ey", "bx", "by"), args))
    got = PongDemoEnv._frame(cfg, st).numpy()
    np.testing.assert_array_equal(np.moveaxis(got, 1, -1), np.asarray(want))


GAME = ("ay", "ey", "bx", "by", "vx", "vy", "score")


def test_parity_with_jax_package():
  """Defaults (gray, 84x84, stack 4, frame_skip 4), the cap cut to 100 so
  that every lane auto-resets, uniform random actions: a reset and 200
  steps, the last 67 from a state whose scores were set one point short of
  21, so that lanes end by the 21-point rule. The JAX pool runs in scans of
  67 steps through its in-jit interface (the first step of the first scan
  is its reset); the game state is compared after every step."""
  n, chunk = 4, 67
  kw = dict(num_envs=n, seed=3, max_episode_steps=100)
  want_env = envpool_tpu.make_gymnasium("PongJaxDemo-v5", **kw)
  handle, _, _, step = want_env.xla()

  def body(h, a):
    h, out = step(h, a)
    return h, (out, {k: h.pool.env[k] for k in GAME})

  scan = jax.jit(lambda h, a: jax.lax.scan(body, h, a))
  got_env = _port(**kw)
  keys = got_env.spec._state_keys
  assert keys == want_env.spec._state_keys
  acts = np.random.default_rng(0).integers(0, 6, (3 * chunk, n)).astype(np.int32)
  acts[0] = 0   # the reset's
  got_env.async_reset()
  ends = 0
  for c in range(3):
    if c == 2:   # every lane one point short of 21, its cap far away
      pool = jax.tree.map(np.asarray, handle.pool)
      score = np.asarray([[20, 20], [20, 20], [20, 19], [19, 20]], np.int32)
      pool = pool._replace(env={**pool.env, "score": score}, elapsed=np.zeros(n, np.int32))
      got_env.load_state(pool)
      handle = handle._replace(pool=jax.tree.map(jnp.asarray, pool))
    handle, (outs, game) = scan(handle, jnp.asarray(acts[c * chunk:(c + 1) * chunk]))
    for i in range(chunk):
      t = c * chunk + i
      if t > 0:
        got_env.send(acts[t])
      got = got_env._recv()
      st = got_env.save_state().env
      for k, g, w in zip(keys, got, outs):
        w = np.asarray(w[i])
        if k == "obs":
          assert_close_frames(g, w, f"step {t}")
        else:
          assert g.dtype == w.dtype and np.array_equal(g, w), (t, k)
      for k in GAME:
        np.testing.assert_array_equal(st[k], np.asarray(game[k][i]), err_msg=f"step {t} {k}")
      if c == 2:
        ends += int(got[keys.index("done")].sum())
  assert ends >= 3
  assert int(np.asarray(handle.pool.env["score"]).sum()) > 0


def test_step_rgb_reward_clip_against_jax_package():
  """The RGB path (frame_skip 2, stack 2, reward_clip) one step from
  mid-game states, the port's batched step against ``jit(vmap)`` of the
  JAX package's: game state, reward and done bit for bit, the stack to the
  resize rule."""
  from envpool_tpu.envs.atari import PongDemoEnv as JaxPongDemoEnv

  kw = dict(gray_scale=False, stack_num=2, reward_clip=True, frame_skip=2)
  cfg = envpool_torch.make_spec("PongJaxDemo-v5", **kw).config
  env = _port(num_envs=16, seed=1, **kw)
  env.reset()
  for act in np.random.default_rng(1).integers(0, 6, (40, 16)).astype(np.int32):
    env.step(act)
  state = env.save_state()
  # lanes 0-3 about to score for the agent, 4-7 for the enemy
  bx, vx, by = state.env["bx"], state.env["vx"], state.env["by"]
  bx[:4], vx[:4], bx[4:8], vx[4:8], by[:8] = 1.0, -2.0, 157.5, 2.0, 40.0
  action = np.random.default_rng(2).integers(0, 6, 16).astype(np.int32)
  keys = state.rng.astype(np.uint32)
  w_st, w_obs, w_rew, w_done, w_info = jax.jit(jax.vmap(
    lambda s, a, k: JaxPongDemoEnv.step(cfg, s, a, k)
  ))({k: jnp.asarray(v) for k, v in state.env.items()}, jnp.asarray(action), jnp.asarray(keys))
  g_st, g_obs, g_rew, g_done, g_info = PongDemoEnv.step(
    cfg, {k: torch.from_numpy(v) for k, v in state.env.items()},
    torch.from_numpy(action), torch.from_numpy(state.rng.astype(np.int64)),
  )
  assert g_obs.shape == (16, 6, 84, 84)
  assert_close_frames(g_obs.numpy(), w_obs)
  for k in GAME:
    np.testing.assert_array_equal(g_st[k].numpy(), np.asarray(w_st[k]), err_msg=k)
  for g, w in ((g_rew, w_rew), (g_done, w_done), (g_info["reward"], w_info["reward"])):
    np.testing.assert_array_equal(g.numpy(), np.asarray(w))
  np.testing.assert_array_equal(g_rew[:8].numpy(), [1.0] * 4 + [-1.0] * 4)


def test_steps_without_reading_the_device():
  cfg = envpool_torch.make_spec("PongJaxDemo-v5").config
  keys = torch.zeros(2, 2, dtype=torch.int64, device="meta")
  state, obs, _ = PongDemoEnv.reset(cfg, None, keys)
  _, obs, rew, done, info = PongDemoEnv.step(
    cfg, state, torch.zeros(2, dtype=torch.int32, device="meta"), keys
  )
  assert obs.shape == (2, 4, 84, 84) and rew.device.type == "meta"


def test_every_dialect_steps():
  for make in (envpool_torch.make_gym, envpool_torch.make_dm):
    env = make("PongJaxDemo-v5", num_envs=2, seed=0, device="cpu")
    env.reset()
    assert env.step(np.full(2, 2, np.int32)) is not None


# ------------------------------------------------------ twins of test_ops.py


def _area_resize_np(img, out_hw):
  h, w = img.shape[-2:]
  oh, ow = out_hw
  x = img.astype(np.float64).reshape(*img.shape[:-2], oh, h // oh, ow, w // ow)
  return np.clip(np.floor(x.mean(axis=(-3, -1)) + 0.5), 0, 255).astype(np.uint8)


def test_resize_integer_factor():
  rng = np.random.default_rng(0)
  img = rng.integers(0, 256, size=(3, 84 * 2, 84 * 2), dtype=np.uint8)
  out = resize_area(torch.from_numpy(img), (84, 84)).numpy()
  ref = _area_resize_np(img, (84, 84))
  assert np.mean(np.abs(out.astype(int) - ref.astype(int)) <= 1) == 1.0
  assert np.mean(out == ref) > 0.99


def test_resize_non_integer_factor_rows_sum():
  img = torch.full((210, 160), 37, dtype=torch.uint8)
  assert (resize_area(img, (84, 84)) == 37).all()


def test_grayscale():
  rng = np.random.default_rng(1)
  img = rng.integers(0, 256, size=(10, 10, 3), dtype=np.uint8)
  out = grayscale(torch.from_numpy(img)).numpy()
  ref = np.clip(
    np.floor(img.astype(np.float64) @ [0.299, 0.587, 0.114] + 0.5), 0, 255
  ).astype(np.uint8)
  assert np.max(np.abs(out.astype(int) - ref.astype(int))) <= 1


def test_maxpool_and_stack():
  a = torch.tensor([[1, 5]], dtype=torch.uint8)
  b = torch.tensor([[3, 2]], dtype=torch.uint8)
  np.testing.assert_array_equal(max_last_two(a, b).numpy(), [[3, 5]])
  out = stack_push(torch.zeros((4, 2, 2), dtype=torch.uint8), torch.ones((2, 2), dtype=torch.uint8))
  assert (out[-1] == 1).all()
  assert (out[:-1] == 0).all()


# ---------------------------------------- twins of test_atari_device_demo.py


def test_device_pipeline_matches_host_numpy():
  """maxpool -> gray -> INTER_AREA resize against the host tier's numpy
  helpers: grayscale bit-exact, the resize to the rule above."""
  from envpool_tpu.envs.atari.atari_env import _resize_area_np

  rng = np.random.default_rng(0)
  f0 = rng.integers(0, 256, (210, 160, 3), dtype=np.uint8)
  f1 = rng.integers(0, 256, (210, 160, 3), dtype=np.uint8)
  w = np.asarray([0.299, 0.587, 0.114], np.float32)
  g0, g1 = (np.clip(np.floor(f.astype(np.float32) @ w + 0.5), 0, 255).astype(np.uint8) for f in (f0, f1))
  t0, t1 = torch.from_numpy(f0), torch.from_numpy(f1)
  np.testing.assert_array_equal(grayscale(t0).numpy(), g0)
  host = _resize_area_np(np.maximum(g0, g1)[..., None], (84, 84))[..., 0]
  dev = resize_area(max_last_two(grayscale(t0), grayscale(t1))[None], (84, 84))[0]
  assert_close_frames(dev.numpy(), host)
  host_rgb = _resize_area_np(np.maximum(f0, f1), (84, 84))
  dev_rgb = resize_area(max_last_two(t0, t1).permute(2, 0, 1), (84, 84))
  assert_close_frames(dev_rgb.numpy(), np.transpose(host_rgb, (2, 0, 1)))


def test_demo_registered_and_steps():
  env = _port(num_envs=4, seed=1)
  obs, info = env.reset()
  assert obs.shape == (4, 4, 84, 84) and obs.dtype == np.uint8
  assert (info["score"] == 0).all()
  tot = np.zeros(4, np.float32)
  for _ in range(32):
    obs, rew, term, trunc, info = env.step(np.full(4, 2, np.int32))
    tot += rew
  assert len(np.unique(obs)) > 2
  net = info["score"][:, 0] - info["score"][:, 1]
  np.testing.assert_array_equal(net.astype(np.float32), tot)


def test_demo_rgb_and_reward_clip():
  env = _port(num_envs=2, seed=0, gray_scale=False, stack_num=2, reward_clip=True)
  obs, _ = env.reset()
  assert obs.shape == (2, 6, 84, 84)
  for _ in range(8):
    obs, rew, *_ = env.step(np.zeros(2, np.int32))
    assert set(np.unique(rew)) <= {-1.0, 0.0, 1.0}


def test_demo_determinism():
  def rollout(seed):
    env = _port(num_envs=2, seed=seed)
    env.reset()
    return np.stack([env.step(np.full(2, t % 6, np.int32))[0] for t in range(10)])

  a, b, c = rollout(7), rollout(7), rollout(8)
  np.testing.assert_array_equal(a, b)
  assert not np.array_equal(a, c)


def test_demo_truncation():
  env = _port(num_envs=2, seed=0, max_episode_steps=5)
  env.reset()
  for _ in range(5):
    obs, rew, term, trunc, info = env.step(np.zeros(2, np.int32))
  assert trunc.all() and info["elapsed_step"].max() == 5


def test_demo_xla_loop():
  env = _port(num_envs=4, seed=0)
  env.reset()
  handle, recv, send, step = env.xla()
  for _ in range(8):
    handle = send(recv(handle)[0], torch.full((4,), 2, dtype=torch.int32))
  assert int(handle.pool.elapsed.max()) == 8
