from ray_tpu_torch.tune.search.searcher import (  # noqa: F401
    ConcurrencyLimiter,
    Searcher,
)
from ray_tpu_torch.tune.search.basic_variant import BasicVariantGenerator  # noqa: F401
from ray_tpu_torch.tune.search.bayesopt import BayesOptSearch  # noqa: F401
from ray_tpu_torch.tune.search.gated import (  # noqa: F401
    AxSearch,
    DragonflySearch,
    HEBOSearch,
    HyperOptSearch,
    NevergradSearch,
    OptunaSearch,
    SigOptSearch,
    SkOptSearch,
    ZOOptSearch,
)
from ray_tpu_torch.tune.search.bohb import TuneBOHB  # noqa: F401
from ray_tpu_torch.tune.search.hyperopt_like import HyperOptLikeSearch  # noqa: F401
from ray_tpu_torch.tune.search.repeater import Repeater  # noqa: F401
