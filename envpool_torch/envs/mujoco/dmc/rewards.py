"""The sigmoid names of dm_control's reward ``tolerance``, the port's own
copy of ``envpool_tpu/envs/mujoco/dmc/rewards.py:13-20``
(``envpool/mujoco/dmc/utils.cc:176-245``, dm_control's
``utils/rewards.py``)."""

GAUSSIAN = "gaussian"
HYPERBOLIC = "hyperbolic"
LONG_TAIL = "long_tail"
RECIPROCAL = "reciprocal"
COSINE = "cosine"
LINEAR = "linear"
QUADRATIC = "quadratic"
TANH_SQUARED = "tanh_squared"
