"""Atari task registration of the port (``envpool_tpu/envs/atari/
registration.py``): only the on-device demo. The ALE ids, which the JAX
package generates from ``ale_py``'s rom list, wait for the host tier
(``ROADMAP.md`` queue 1, item 9)."""

from envpool_torch.registration import register

register(
  task_id="PongJaxDemo-v5",
  import_path="envpool_torch.envs.atari",
  spec_cls="PongDemoEnvSpec",
  dm_cls="PongDemoDMEnvPool",
  gym_cls="PongDemoGymEnvPool",
  gymnasium_cls="PongDemoGymnasiumEnvPool",
  max_episode_steps=27000,
)
