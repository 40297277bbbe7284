"""Entry point importing every ported family's registration."""

import envpool_torch.envs.box2d.registration  # noqa: F401
