"""Entry point importing every ported family's registration, in the JAX
package's order (``envpool_tpu/entry.py``)."""

import envpool_torch.envs.dummy.registration  # noqa: F401
import envpool_torch.envs.classic_control.registration  # noqa: F401
import envpool_torch.envs.toy_text.registration  # noqa: F401
import envpool_torch.envs.box2d.registration  # noqa: F401
import envpool_torch.envs.atari.registration  # noqa: F401
import envpool_torch.envs.mujoco.registration  # noqa: F401
import envpool_torch.envs.mujoco.dmc.registration  # noqa: F401
import envpool_torch.envs.minigrid.registration  # noqa: F401
import envpool_torch.envs.sokoban.registration  # noqa: F401
