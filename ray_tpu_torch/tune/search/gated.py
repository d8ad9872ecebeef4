"""Gated external-searcher wrappers.

The reference wraps a dozen third-party optimizers (python/ray/tune/search/
{optuna,hyperopt,ax,bohb,dragonfly,flaml,hebo,nevergrad,sigopt,skopt,zoopt});
the port depends on none of those packages, so each name constructs with a
clear install message (same behavior the reference shows when the backing
package is missing). BayesOptSearch (its own Gaussian process) and
HyperOptLikeSearch are the built-in alternatives.
"""

from __future__ import annotations

from ray_tpu_torch.tune.search.searcher import Searcher


def _gated(name: str, package: str):
    class _Gated(Searcher):
        def __init__(self, *a, **k):
            raise ImportError(
                f"{name} requires the '{package}' package, which is not "
                f"installed in this environment (pip install {package}). "
                "Built-in alternatives: BayesOptSearch (Gaussian process) or "
                "HyperOptLikeSearch."
            )

    _Gated.__name__ = name
    return _Gated


OptunaSearch = _gated("OptunaSearch", "optuna")
HyperOptSearch = _gated("HyperOptSearch", "hyperopt")
AxSearch = _gated("AxSearch", "ax-platform")
DragonflySearch = _gated("DragonflySearch", "dragonfly-opt")
NevergradSearch = _gated("NevergradSearch", "nevergrad")
SigOptSearch = _gated("SigOptSearch", "sigopt")
SkOptSearch = _gated("SkOptSearch", "scikit-optimize")
ZOOptSearch = _gated("ZOOptSearch", "zoopt")
HEBOSearch = _gated("HEBOSearch", "HEBO")
