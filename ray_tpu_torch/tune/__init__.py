"""ray_tpu_torch.tune — what of Tune the port has so far: the Trainable
protocol's class API (``trainable.py``), which RLlib's ``Algorithm``
extends.

The rest of the JAX package's ``tune/`` (``Tuner``, the function
API, the search algorithms, schedulers, loggers and syncers) is not ported
yet (ROADMAP A14).
"""

from ray_tpu_torch.tune.trainable import Trainable  # noqa: F401
