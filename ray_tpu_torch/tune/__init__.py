"""ray_tpu_torch.tune — the experiment runner (analog of python/ray/tune).

Tuner/tune.run drive trials-as-actors through a TuneController with pluggable
searchers (grid/random/model-based) and schedulers (FIFO/ASHA/median/PBT);
every other library's .fit() can route through it like the reference
(base_trainer.py:559). Tune's own work (variants, searchers, schedulers, the
Gaussian process, loggers) stays on the host; the trials' work runs on the
card through their trainables (``TorchTrainer``, RLlib's ``Algorithm``s, a
function that trains on ``train.torch.get_device()``)."""

from ray_tpu_torch.tune.sample import (  # noqa: F401
    choice,
    grid_search,
    lograndint,
    loguniform,
    qloguniform,
    qrandint,
    quniform,
    randint,
    randn,
    sample_from,
    uniform,
)
from ray_tpu_torch.tune.trainable import (  # noqa: F401
    FunctionTrainable,
    Trainable,
    get_checkpoint,
    report,
)
from ray_tpu_torch.air.config import CheckpointConfig, FailureConfig, RunConfig  # noqa: F401
from ray_tpu_torch.tune.tune_config import TuneConfig  # noqa: F401
from ray_tpu_torch.tune.analysis import ExperimentAnalysis  # noqa: F401
from ray_tpu_torch.tune.result_grid import ResultGrid  # noqa: F401
from ray_tpu_torch.tune.tuner import Tuner, run  # noqa: F401
