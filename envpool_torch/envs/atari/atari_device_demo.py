"""On-device Atari parity demo (PongJaxDemo-v5) — batched PyTorch.

The port of ``envpool_tpu/envs/atari/atari_device_demo.py``: a Pong-style
game that renders real 210x160 frames on the device and consumes them
through the wrapper stack the reference implements in C++
(``envpool/atari/atari_env.h``): frame_skip with the elementwise max over
the last two skipped frames (``atari_env.h:269-276``; only those two are
rendered), BT.601 grayscale, INTER_AREA resize to 84x84
(``envpool_torch.ops.image``), stack_num frame stacking with push-all on
reset (``atari_env.h:281-287``), reward_clip to sign
(``atari_env.h:217-223``). The game is not the ALE Pong ROM; its point is
the frame pipeline.

Game rules (as in the JAX package): 160x210 court, play rows [34, 194);
the right paddle is the agent, the left a tracking opponent; the ball
bounces off walls and paddles (paddle hits re-angle it by hit offset); 6
actions (NOOP/FIRE/UP/DOWN/UPFIRE/DOWNFIRE), paddles move 4 px per frame;
a point when the ball leaves either side, a serve from the centre toward
the side that lost it; the episode ends at 21 points either side.

Batched form. The serves of all ``frame_skip`` sub-steps are drawn in one
batched call before the sub-step loop: their keys come from
``split(key, frame_skip)`` and do not depend on the game, so the draws are
the JAX package's bit for bit. A frame is painted channel by channel from
the objects' masks with the palette's values (the four grey values, from
``grayscale`` of the four colours, or the RGB ones), never through a float
RGB frame: grayscale is per pixel, so the bytes equal the JAX order (RGB,
then grayscale) that ``render_frame`` keeps for the tests.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch

from envpool_torch.core import prng
from envpool_torch.core.env import FuncEnv
from envpool_torch.core.spec import ArraySpec
from envpool_torch.ops import image as img_ops

RAW_H, RAW_W = 210, 160
TOP, BOT = 34, 194          # play-area rows [TOP, BOT)
PAD_H, PAD_W = 16, 4        # paddle size
BALL_H, BALL_W = 4, 2       # ball size (rows x cols)
AGENT_X, ENEMY_X = 140, 16  # paddle column anchors
PADDLE_SPEED = 4
ENEMY_SPEED = 2
WIN_SCORE = 21

# ALE pong palette flavors (uint8 RGB): background, agent, enemy, ball
PALETTE = np.asarray(
  [[144, 72, 17], [92, 186, 92], [213, 130, 74], [236, 236, 236]], np.uint8
)


def _masks(ay, ey, bx, by):
  """Where the agent, the enemy and the ball lie in the frames of game
  state ``[N]`` tensors: three ``[N, 210, 160]`` bool masks, each one
  full-size AND of a row mask ``[N, 210, 1]`` and a column mask."""
  device = ay.device
  rows = torch.arange(RAW_H, dtype=torch.int32, device=device)[None, :, None]
  cols = torch.arange(RAW_W, dtype=torch.int32, device=device)[None, None, :]
  in_play = (rows >= TOP) & (rows < BOT)

  def box(top, height, left, width):
    top = top[:, None, None]
    return (in_play & (rows >= top) & (rows < top + height)) & (
      (cols >= left) & (cols < left + width))

  bxi = torch.round(bx).to(torch.int32)[:, None, None]
  byi = torch.round(by).to(torch.int32)
  return (box(ay, PAD_H, AGENT_X, PAD_W), box(ey, PAD_H, ENEMY_X, PAD_W),
          box(byi, BALL_H, bxi, BALL_W))


def _paint(masks, colours) -> torch.Tensor:
  """One uint8 channel ``[N, 210, 160]``: ``colours`` are the background's,
  the agent's, the enemy's and the ball's values, later objects drawn over
  earlier ones as in the JAX package."""
  bg, *fills = (int(c) for c in colours)
  frame = torch.full(masks[0].shape, bg, dtype=torch.uint8, device=masks[0].device)
  for mask, value in zip(masks, fills):
    frame.masked_fill_(mask, value)
  return frame


@functools.lru_cache(maxsize=1)
def _grey_palette() -> Tuple[int, ...]:
  """The grey values of the four colours, by the same ``grayscale`` the JAX
  order applies to every pixel of the RGB frame."""
  return tuple(int(v) for v in img_ops.grayscale(torch.from_numpy(PALETTE)))


def render_frame(ay, ey, bx, by, gray: bool) -> torch.Tensor:
  """Frames in the JAX package's order: RGB [N, 210, 160, 3] uint8, or
  grayscale [N, 210, 160, 1] converted from the RGB frame."""
  masks = _masks(ay, ey, bx, by)
  frame = torch.stack([_paint(masks, PALETTE[:, c]) for c in range(3)], -1)
  if gray:
    return img_ops.grayscale(frame)[..., None]
  return frame


class PongDemoEnv(FuncEnv):
  """On-device Pong-style demo with the full Atari wrapper stack."""

  name = "PongDemo"

  @staticmethod
  def default_config() -> Dict[str, Any]:
    # the wrapper-stack slice of the Atari config (atari_env.h:50-59)
    return {
      "stack_num": 4, "frame_skip": 4, "img_height": 84, "img_width": 84,
      "gray_scale": True, "reward_clip": False,
    }

  @staticmethod
  def state_spec(cfg: Any) -> Dict[str, ArraySpec]:
    c = 1 if cfg.gray_scale else 3
    return {
      "obs": ArraySpec(
        np.uint8,
        (int(cfg.stack_num) * c, int(cfg.img_height), int(cfg.img_width)),
        0, 255,
      ),
      "info:score": ArraySpec(np.int32, (2,)),
      "info:reward": ArraySpec(np.float32, (-1,)),
    }

  @staticmethod
  def action_spec(cfg: Any) -> Dict[str, ArraySpec]:
    return {"action": ArraySpec(np.int32, (-1,), 0, 5)}

  # ---------------------------------------------------------------- helpers

  @staticmethod
  def _serve_vy(keys: torch.Tensor) -> torch.Tensor:
    """The serve's vy for keys ``[..., 2]``: uniform in ±[1, 3]."""
    kvy, ksg = prng.split(keys, 2).unbind(-2)
    vy = prng.uniform(kvy, (), 1.0, 3.0)
    return vy * torch.where(prng.bernoulli(ksg), 1.0, -1.0)

  @staticmethod
  def _frame(cfg: Any, st: Dict[str, torch.Tensor]) -> torch.Tensor:
    """[N, C, 210, 160] uint8 frame, each channel painted straight from the
    masks with the palette's values."""
    masks = _masks(st["ay"], st["ey"], st["bx"], st["by"])
    channels = [_grey_palette()] if cfg.gray_scale else PALETTE.T
    return torch.stack([_paint(masks, c) for c in channels], 1)

  @staticmethod
  def _process(cfg: Any, f0: torch.Tensor, f1: torch.Tensor) -> torch.Tensor:
    """maxpool(last two frames) -> resize: one [N, C, h, w] stack slot."""
    return img_ops.resize_area(
      img_ops.max_last_two(f0, f1), (int(cfg.img_height), int(cfg.img_width))
    )

  @staticmethod
  def _advance(st: Dict[str, torch.Tensor], action: torch.Tensor, serve_vy):
    """One 60 Hz game frame. Returns (state', point_reward)."""
    ay, ey = st["ay"], st["ey"]
    bx, by, vx, vy = st["bx"], st["by"], st["vx"], st["vy"]
    up = (action == 2) | (action == 4)
    down = (action == 3) | (action == 5)
    ay = ay + torch.where(up, -PADDLE_SPEED, torch.where(down, PADDLE_SPEED, 0))
    ay = torch.clamp(ay, TOP, BOT - PAD_H).to(torch.int32)
    # opponent tracks the ball center (int32 + python float -> float32)
    bc = by + BALL_H / 2.0
    ec = ey + PAD_H / 2.0
    ey = ey + torch.where(
      bc > ec + 1, ENEMY_SPEED, torch.where(bc < ec - 1, -ENEMY_SPEED, 0)
    )
    ey = torch.clamp(ey, TOP, BOT - PAD_H).to(torch.int32)

    bx = bx + vx
    by = by + vy
    # wall bounce (reflect inside [TOP, BOT - BALL_H])
    over_top = by < TOP
    over_bot = by > BOT - BALL_H
    by = torch.where(over_top, 2 * TOP - by, by)
    by = torch.where(over_bot, 2 * (BOT - BALL_H) - by, by)
    vy = torch.where(over_top | over_bot, -vy, vy)
    # paddle bounce: ball crossing the paddle column while overlapping
    hit_agent = (
      (vx > 0) & (bx + BALL_W >= AGENT_X) & (bx + BALL_W < AGENT_X + PAD_W)
      & (by + BALL_H >= ay) & (by <= ay + PAD_H)
    )
    hit_enemy = (
      (vx < 0) & (bx <= ENEMY_X + PAD_W) & (bx > ENEMY_X)
      & (by + BALL_H >= ey) & (by <= ey + PAD_H)
    )
    vx = torch.where(hit_agent | hit_enemy, -vx, vx)
    bx = torch.where(hit_agent, float(AGENT_X - BALL_W), bx)
    bx = torch.where(hit_enemy, float(ENEMY_X + PAD_W), bx)
    # re-angle by hit offset (clamped), pong's control mechanic
    off_a = (by + BALL_H / 2.0 - (ay + PAD_H / 2.0)) / (PAD_H / 2.0)
    off_e = (by + BALL_H / 2.0 - (ey + PAD_H / 2.0)) / (PAD_H / 2.0)
    vy = torch.where(hit_agent, torch.clamp(3.0 * off_a, -3.0, 3.0), vy)
    vy = torch.where(hit_enemy, torch.clamp(3.0 * off_e, -3.0, 3.0), vy)

    # scoring: ball fully out either side; serve from the centre
    agent_scores = bx < 0.0
    enemy_scores = bx > RAW_W - BALL_W
    scored = agent_scores | enemy_scores
    bx = torch.where(scored, float(RAW_W // 2), bx)
    by = torch.where(scored, float((TOP + BOT) // 2), by)
    vx = torch.where(scored, torch.where(enemy_scores, 2.0, -2.0), vx)
    vy = torch.where(scored, serve_vy, vy)
    reward = agent_scores.to(torch.float32) - enemy_scores.to(torch.float32)
    score = st["score"] + torch.stack([agent_scores, enemy_scores], 1).to(torch.int32)
    out = dict(st, ay=ay, ey=ey, bx=bx, by=by, vx=vx, vy=vy, score=score)
    return out, reward

  # ---------------------------------------------------------------- env API

  @classmethod
  def reset(cls, cfg: Any, state: Any, keys: torch.Tensor):
    del state
    n, device = keys.shape[0], keys.device
    kserve, kside = prng.split(keys, 2).unbind(1)
    mid = torch.full((n,), (TOP + BOT - PAD_H) // 2, dtype=torch.int32, device=device)
    st = {
      "ay": mid, "ey": mid,
      "bx": torch.full((n,), float(RAW_W // 2), device=device),
      "by": torch.full((n,), float((TOP + BOT) // 2), device=device),
      "vx": torch.where(prng.bernoulli(kside), 2.0, -2.0),
      "vy": cls._serve_vy(kserve),
      "score": torch.zeros((n, 2), dtype=torch.int32, device=device),
    }
    frame = cls._frame(cfg, st)
    slot = cls._process(cfg, frame, frame)  # push-all on reset
    st["stack"] = slot.repeat(1, int(cfg.stack_num), 1, 1)
    return st, st["stack"], cls._info(st, torch.zeros(n, device=device))

  @classmethod
  def step(cls, cfg: Any, state: Any, action: torch.Tensor, keys: torch.Tensor):
    skip = int(cfg.frame_skip)
    # every sub-step's serve, drawn at once from split(key, skip)
    serve_vy = cls._serve_vy(prng.split(keys, skip))  # [N, skip]
    st = {k: v for k, v in state.items() if k != "stack"}
    reward = torch.zeros(action.shape[0], device=keys.device)
    frames = []
    # like the reference: act frame_skip times, grab only the last two
    # frames for the maxpool (atari_env.h:186-205)
    for i in range(skip):
      st, r = cls._advance(st, action, serve_vy[:, i])
      reward = reward + r
      if i >= skip - 2:
        frames.append(cls._frame(cfg, st))
    if len(frames) == 1:  # frame_skip == 1
      frames = [frames[0], frames[0]]
    slot = cls._process(cfg, frames[0], frames[1])
    n, c = slot.shape[:2]
    stack = img_ops.stack_push(
      state["stack"].reshape(n, int(cfg.stack_num), c, *slot.shape[2:]), slot, dim=1
    )
    st["stack"] = stack.reshape(state["stack"].shape)
    done = (st["score"] >= WIN_SCORE).any(1)
    info_reward = reward
    if bool(cfg.reward_clip):
      reward = torch.sign(reward)
    return st, st["stack"], reward, done, cls._info(st, info_reward)

  @staticmethod
  def _info(st: Dict[str, torch.Tensor], reward: torch.Tensor) -> Dict[str, Any]:
    return {"score": st["score"], "reward": reward}
