"""dm_control task registration of the port: the on-device ``-Jax-v1`` ids
of ``envpool_tpu/envs/mujoco/registration.py:115-166``, in its order and
with the same class names, task names and caps. The host tier's ``-v1``
ids wait for their slice."""

from envpool_torch.registration import register

for _domain, _task, _max_episode_steps in [
  ("acrobot", "swingup", 1000),
  ("ball_in_cup", "catch", 1000),
  ("humanoid", "stand", 1000),
  ("humanoid", "walk", 1000),
  ("humanoid", "run", 1000),
  ("humanoid", "run_pure_state", 1000),
  ("humanoid_CMU", "stand", 1000),
  ("humanoid_CMU", "run", 1000),
  ("manipulator", "bring_ball", 1000),
  ("manipulator", "bring_peg", 1000),
  ("manipulator", "insert_ball", 1000),
  ("manipulator", "insert_peg", 1000),
  ("acrobot", "swingup_sparse", 1000),
  ("cartpole", "balance", 1000),
  ("cartpole", "balance_sparse", 1000),
  ("cartpole", "swingup", 1000),
  ("cartpole", "swingup_sparse", 1000),
  ("cartpole", "two_poles", 1000),
  ("cartpole", "three_poles", 1000),
  ("cheetah", "run", 1000),
  ("finger", "spin", 1000),
  ("finger", "turn_easy", 1000),
  ("finger", "turn_hard", 1000),
  ("fish", "upright", 1000),
  ("fish", "swim", 1000),
  ("swimmer", "swimmer6", 1000),
  ("swimmer", "swimmer15", 1000),
  ("hopper", "stand", 1000),
  ("hopper", "hop", 1000),
  ("walker", "stand", 1000),
  ("walker", "walk", 1000),
  ("walker", "run", 1000),
  ("pendulum", "swingup", 1000),
  ("point_mass", "easy", 1000),
  ("point_mass", "hard", 1000),
  ("reacher", "easy", 1000),
  ("reacher", "hard", 1000),
]:
  _domain_name = "".join(g[:1].upper() + g[1:] for g in _domain.split("_"))
  _task_name = "".join(g[:1].upper() + g[1:] for g in _task.split("_"))
  register(
    task_id=f"{_domain_name}Jax{_task_name}-v1",
    import_path="envpool_torch.envs.mujoco.dmc",
    spec_cls=f"Dmc{_domain_name}JaxEnvSpec",
    dm_cls=f"Dmc{_domain_name}JaxDMEnvPool",
    gym_cls=f"Dmc{_domain_name}JaxGymEnvPool",
    gymnasium_cls=f"Dmc{_domain_name}JaxGymnasiumEnvPool",
    task_name=_task,
    max_episode_steps=_max_episode_steps,
  )
