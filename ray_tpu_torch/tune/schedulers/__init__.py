from ray_tpu_torch.tune.schedulers.trial_scheduler import (  # noqa: F401
    CONTINUE,
    PAUSE,
    STOP,
    FIFOScheduler,
    TrialScheduler,
)
from ray_tpu_torch.tune.schedulers.asha import ASHAScheduler  # noqa: F401
from ray_tpu_torch.tune.schedulers.hyperband import HyperBandScheduler  # noqa: F401
from ray_tpu_torch.tune.schedulers.median_stopping import MedianStoppingRule  # noqa: F401
from ray_tpu_torch.tune.schedulers.pb2 import PB2  # noqa: F401
from ray_tpu_torch.tune.schedulers.pbt import PopulationBasedTraining  # noqa: F401
from ray_tpu_torch.tune.schedulers.resource_changing import (  # noqa: F401
    DistributeResources,
    ResourceChangingScheduler,
)

AsyncHyperBandScheduler = ASHAScheduler
# BOHB pairs the TuneBOHB searcher with synchronous HyperBand rungs
# (reference: hb_bohb.py) — our sync HyperBand already pauses at
# milestones, which is the behavior HyperBandForBOHB adds there.
HyperBandForBOHB = HyperBandScheduler
