"""PPO on the on-device MuJoCo tier over the port (the port's
``examples/ppo_mujoco.py``): the physics engine, the rollout, GAE and the
Gaussian-policy PPO update all on the pool's device, envs split over the
mesh.

Run:  python -m envpool_torch.examples.ppo_mujoco --task HalfCheetahJax-v4 \\
          --num-envs 2048 --iterations 100
"""

import argparse
import time
from typing import Dict, List, Optional, Sequence

import envpool_torch
from envpool_torch.examples import mesh_for
from envpool_torch.models import GaussianMLPActorCritic
from envpool_torch.parallel import ShardedEnvPool
from envpool_torch.train import PPOConfig, make_ppo_train_step, ppo_init


def main(argv: Optional[Sequence[str]] = None) -> List[Dict[str, float]]:
  p = argparse.ArgumentParser()
  p.add_argument("--task", type=str, default="HalfCheetahJax-v4")
  p.add_argument("--num-envs", type=int, default=2048)
  p.add_argument("--iterations", type=int, default=100)
  p.add_argument("--num-steps", type=int, default=32)
  p.add_argument("--lr", type=float, default=3e-4)
  p.add_argument("--seed", type=int, default=0)
  p.add_argument("--device", type=str, default="cuda",
                 help="'cuda': every CUDA device; else one device ('cpu')")
  args = p.parse_args(argv)

  mesh = mesh_for(args.device)
  pool = ShardedEnvPool(
    envpool_torch.make_spec(
      args.task, num_envs=args.num_envs, seed=args.seed
    ),
    mesh=mesh,
  )

  act_spec = pool.spec.action_array_spec["action"]
  net = GaussianMLPActorCritic(action_dim=int(act_spec.static_shape[-1]))
  cfg = PPOConfig(
    num_steps=args.num_steps, lr=args.lr, continuous=True,
    ent_coef=0.0, update_epochs=4, num_minibatches=8,
  )
  state, tx = ppo_init(pool, net, cfg, seed=args.seed)
  train_step = make_ppo_train_step(pool, net, cfg, tx, mesh=mesh)

  steps_per_iter = args.num_envs * args.num_steps
  history = []
  for it in range(args.iterations):
    t0 = time.time()
    state, metrics = train_step(state)
    metrics = {k: float(v) for k, v in metrics.items()}
    dt = time.time() - t0
    history.append({**metrics, "sps": steps_per_iter / dt})
    print(
      f"iter {it:4d}  reward {metrics['mean_reward']:+.4f}  "
      f"pg {metrics['pg_loss']:+.4f}  "
      f"v {metrics['v_loss']:.4f}  "
      f"{steps_per_iter / dt:,.0f} env-steps/s",
      flush=True,
    )
  return history


if __name__ == "__main__":
  main()
