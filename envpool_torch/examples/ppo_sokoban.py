"""PPO on Sokoban over the port (the port's ``examples/ppo_sokoban.py``).

The pool is a ``ShardedEnvPool`` over ``make_mesh()`` (every CUDA device,
one block of envs each); one iteration is the rollout through the pool's
``xla()`` interface, GAE and the clipped-surrogate update on the mesh
(``make_ppo_train_step(..., mesh=mesh)``), run eagerly.

Run:  python -m envpool_torch.examples.ppo_sokoban --num-envs 1024 --iterations 50
"""

import argparse
import time
from typing import Dict, List, Optional, Sequence

import envpool_torch
from envpool_torch.examples import mesh_for
from envpool_torch.models import SokobanCNN
from envpool_torch.parallel import ShardedEnvPool
from envpool_torch.train import PPOConfig, make_ppo_train_step, ppo_init


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, float]]:
  p = argparse.ArgumentParser()
  p.add_argument("--num-envs", type=int, default=1024)
  p.add_argument("--iterations", type=int, default=50)
  p.add_argument("--num-steps", type=int, default=32)
  p.add_argument("--lr", type=float, default=2.5e-4)
  p.add_argument("--seed", type=int, default=0)
  p.add_argument("--device", type=str, default="cuda",
                 help="'cuda': every CUDA device; else one device ('cpu')")
  args = p.parse_args(argv)

  mesh = mesh_for(args.device)
  spec = envpool_torch.make_spec(
    "Sokoban-v0", num_envs=args.num_envs, seed=args.seed,
    max_episode_steps=60, levels_dir="", n_levels_to_load=1024,
  )
  pool = ShardedEnvPool(spec, mesh=mesh)
  net = SokobanCNN()
  cfg = PPOConfig(num_steps=args.num_steps, lr=args.lr)
  state, tx = ppo_init(pool, net, cfg, seed=args.seed)
  train_step = make_ppo_train_step(pool, net, cfg, tx, mesh=mesh)

  steps_per_iter = args.num_envs * args.num_steps
  history = []
  for it in range(args.iterations):
    t0 = time.perf_counter()
    state, metrics = train_step(state)
    metrics = {k: float(v) for k, v in metrics.items()}
    dt = time.perf_counter() - t0
    history.append({**metrics, "sps": steps_per_iter / dt})
    print(
      f"iter {it:4d}  reward/step {metrics['mean_reward']:+.4f}  "
      f"pg {metrics['pg_loss']:+.4f}  "
      f"v {metrics['v_loss']:.4f}  "
      f"ent {metrics['entropy']:.3f}  "
      f"sps {steps_per_iter / dt:,.0f}",
      flush=True,
    )
  return history


if __name__ == "__main__":
  main()
