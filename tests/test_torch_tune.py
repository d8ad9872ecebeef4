"""The port's Tune, with no cluster, against the JAX package's, decision for
decision: the same seeds give the same variants (grid order included); the
searchers fed the same observation stream suggest the same configs; the
schedulers, driven through the same scripted sweep, make the same decisions
(CONTINUE/STOP/PAUSE, HyperBand's starts and halvings, PBT's and PB2's donors
and mutated configs); and the port's Gaussian process (``tune/search/_gp.py``)
against scikit-learn's ``GaussianProcessRegressor`` on the reference tests'
data and on degenerate inputs. Run alone: ~10 s.

Every case runs with one BLAS thread: the Gaussian processes' small
products gain nothing from more, and beside other busy processes (pytest's
workers) a pool of spinning BLAS threads made the file 3x slower.
"""

import random
import warnings

import numpy as np
import pytest

import ray_tpu
import ray_tpu.tune as jtune
import ray_tpu_torch
import ray_tpu_torch.tune as ttune
from ray_tpu.tune import schedulers as jsched
from ray_tpu.tune import search as jsearch
from ray_tpu.tune.experiment import trial as jtrial
from ray_tpu.tune.search import bayesopt as jbayesopt
from ray_tpu_torch.tune import schedulers as tsched
from ray_tpu_torch.tune import search as tsearch
from ray_tpu_torch.tune.experiment import trial as ttrial
from ray_tpu_torch.tune.search import bayesopt as tbayesopt
from ray_tpu_torch.tune.search._gp import GaussianProcess

PKGS = {
    "ref": dict(tune=jtune, sched=jsched, search=jsearch, trial=jtrial, root=ray_tpu),
    "port": dict(tune=ttune, sched=tsched, search=tsearch, trial=ttrial, root=ray_tpu_torch),
}

# The GP's hyperparameters, posterior mean and std against scikit-learn's:
# the port runs the same numpy/scipy operations in the same order, and on
# one numpy and scipy every case agrees bit for bit; the bar leaves room
# for a BLAS that orders a sum differently.
GP_RTOL = 1e-12


@pytest.fixture(autouse=True)
def _one_blas_thread():
    from threadpoolctl import threadpool_limits

    with threadpool_limits(limits=1, user_api="blas"):
        yield


def _space(tune):
    """A space with every domain kind, nested dicts and two grid axes."""
    return {
        "lr": tune.loguniform(1e-4, 1e-1),
        "mom": tune.uniform(0.5, 0.99),
        "q": tune.quniform(0.0, 1.0, 0.25),
        "ql": tune.qloguniform(1e-3, 1.0, 1e-3),
        "layers": tune.randint(1, 6),
        "width": tune.qrandint(16, 129, 16),
        "heads": tune.lograndint(1, 17),
        "act": tune.choice(["relu", "tanh", "gelu"]),
        "opt": {"name": tune.grid_search(["adam", "sgd"]), "eps": tune.loguniform(1e-9, 1e-6)},
        "seed": tune.grid_search([0, 1, 2]),
        "double_lr": tune.sample_from(lambda spec: spec.config["lr"] * 2),
        "noise": tune.randn(0.0, 1.0),
        "const": 7,
    }


def _variants(pkg, seed, num_samples):
    random.seed(seed)  # randn draws from the global stream, in both packages
    g = pkg["search"].BasicVariantGenerator(_space(pkg["tune"]), num_samples=num_samples, seed=seed)
    total = g.total_samples
    out = [g.suggest(str(i)) for i in range(total)]
    assert g.suggest("extra") is None
    return total, out


@pytest.mark.parametrize("seed,num_samples", [(0, 1), (3, 2), (11, 3)])
def test_variants_equal_the_reference(seed, num_samples):
    ref_total, ref = _variants(PKGS["ref"], seed, num_samples)
    port_total, port = _variants(PKGS["port"], seed, num_samples)
    assert port_total == ref_total == 6 * num_samples
    assert port == ref
    # Grid order: the cross-product in declaration order, repeated per sample.
    assert [(c["opt"]["name"], c["seed"]) for c in port[:6]] == [
        (n, s) for n in ("adam", "sgd") for s in (0, 1, 2)]


def test_domains_and_resolve_equal_the_reference():
    for name in ("uniform", "loguniform", "quniform", "randint", "qrandint", "lograndint", "choice"):
        args = {"uniform": (0, 1), "loguniform": (1e-4, 1e-1), "quniform": (0, 1, 0.25), "randint": (2, 8),
                "qrandint": (0, 100, 5), "lograndint": (1, 1000), "choice": (["a", "b", "c"],)}[name]
        rj, rt_ = random.Random(5), random.Random(5)
        dj, dt = getattr(jtune, name)(*args), getattr(ttune, name)(*args)
        assert [dj.sample(rj) for _ in range(200)] == [dt.sample(rt_) for _ in range(200)], name
        assert repr(dj) == repr(dt)
    from ray_tpu.tune import sample as js
    from ray_tpu_torch.tune import sample as ts

    space_j = {"a": jtune.choice([4]), "b": jtune.sample_from(lambda spec: spec.config["a"] * 2)}
    space_t = {"a": ttune.choice([4]), "b": ttune.sample_from(lambda spec: spec.config["a"] * 2)}
    assert ts.resolve(space_t, random.Random(0)) == js.resolve(space_j, random.Random(0)) == {"a": 4, "b": 8}
    with pytest.raises(ValueError, match="lower > 0"):
        ttune.loguniform(0, 1)


def test_concurrency_limiter_equals_the_reference():
    logs = []
    for pkg in PKGS.values():
        s = pkg["search"]
        g = s.ConcurrencyLimiter(s.BasicVariantGenerator({"x": pkg["tune"].uniform(0, 1)}, num_samples=5, seed=0), 2)
        log = [g.suggest("t1"), g.suggest("t2"), g.suggest("t3")]
        g.on_trial_complete("t1", {"m": 1})
        log += [g.suggest("t3"), g.total_samples]
        logs.append(log)
    assert logs[0] == logs[1]
    assert logs[1][2] is None and logs[1][3] is not None


# -- searchers fed one observation stream ------------------------------------

def _objective(cfg):
    return -((cfg["x"] - 3.0) ** 2) - (cfg.get("y", 3.0) - 3.0) ** 2


def _drive_searcher(searcher, n, metric="score", iters=1, noise=None):
    """suggest -> result(s) -> complete, one trial at a time; returns every
    suggestion."""
    rng = random.Random(1)
    suggested = []
    for i in range(n):
        tid = f"t{i:03d}"
        cfg = searcher.suggest(tid)
        suggested.append(cfg)
        if cfg is None:
            continue
        result = None
        for it in range(1, iters + 1):
            score = _objective(cfg) * (1.0 + 0.1 * (iters - it)) + (rng.gauss(0, noise) if noise else 0.0)
            result = {metric: score, "training_iteration": it}
            searcher.on_trial_result(tid, result)
        searcher.on_trial_complete(tid, result)
    return suggested


SEARCHERS = {
    "hyperopt_like": lambda p: p["search"].HyperOptLikeSearch(
        {"x": p["tune"].uniform(0, 6), "y": p["tune"].uniform(0, 6)}, metric="score", mode="max",
        n_initial_points=3, seed=0),
    "repeater": lambda p: p["search"].Repeater(p["search"].HyperOptLikeSearch(
        {"x": p["tune"].uniform(0, 6)}, metric="score", mode="max", n_initial_points=2, seed=0), repeat=3),
    "bayesopt": lambda p: p["search"].BayesOptSearch(
        {"x": p["tune"].uniform(0.0, 6.0)}, metric="score", mode="max", random_startup_trials=4, seed=0),
    "bayesopt_mixed": lambda p: p["search"].BayesOptSearch(
        {"x": p["tune"].uniform(0.0, 6.0), "y": p["tune"].quniform(0.0, 6.0, 0.5),
         "n": p["tune"].randint(1, 9), "act": p["tune"].choice(["relu", "tanh"]),
         "lr": p["tune"].loguniform(1e-4, 1e-1), "const": 3}, metric="score", mode="min",
        random_startup_trials=3, seed=2),
    "bohb": lambda p: p["search"].TuneBOHB(
        {"x": p["tune"].uniform(0.0, 6.0), "y": p["tune"].uniform(0.0, 6.0)}, metric="score", mode="max",
        min_points=6, random_fraction=0.15, seed=0),
}


@pytest.mark.parametrize("name,n,iters,noise", [
    ("hyperopt_like", 14, 1, None),
    ("repeater", 12, 1, 0.5),
    ("bayesopt", 15, 1, None),
    ("bayesopt_mixed", 12, 1, None),
    ("bohb", 24, 3, None),
])
def test_searcher_suggestions_equal_the_reference(name, n, iters, noise):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # scikit-learn's ConvergenceWarnings
        ref = _drive_searcher(SEARCHERS[name](PKGS["ref"]), n, iters=iters, noise=noise)
    port = _drive_searcher(SEARCHERS[name](PKGS["port"]), n, iters=iters, noise=noise)
    assert port == ref
    assert all(c is not None for c in port)
    if name == "repeater":
        assert [c["__trial_index__"] for c in port] == [0, 1, 2] * 4
        assert len({c["x"] for c in port}) == 4


def test_bohb_model_budget_and_preference_equal_the_reference():
    picks, budgets = [], []
    for pkg in PKGS.values():
        s = pkg["search"].TuneBOHB({"x": pkg["tune"].uniform(0.0, 1.0)}, metric="score", mode="max",
                                   min_points=6, random_fraction=0.0, seed=1)
        for i in range(20):
            tid = f"seed{i}"
            x = 0.8 + 0.02 * (i % 3) if i % 2 == 0 else 0.15 + 0.02 * (i % 5)
            s._live[tid] = [x]
            s.on_trial_result(tid, {"score": -abs(x - 0.8) * 10, "training_iteration": 1})
            s.on_trial_complete(tid)
        picks.append([s.suggest(f"t{i}")["x"] for i in range(8)])
        b = pkg["search"].TuneBOHB({"x": pkg["tune"].uniform(0.0, 1.0)}, metric="score", mode="max", min_points=3)
        log = []
        for prefix, n, it in (("a", 6, 1), ("b", 3, 4), ("c", 2, 9)):
            for i in range(n):
                b._live[f"{prefix}{i}"] = [i / 10]
                b.on_trial_result(f"{prefix}{i}", {"score": 1.0, "training_iteration": it})
            log.append(b._model_budget())
        budgets.append(log)
    assert picks[0] == picks[1]
    assert np.mean([0.6 <= p <= 1.0 for p in picks[1]]) >= 0.75
    assert budgets[0] == budgets[1] == [1, 4, 4]


def test_bayesopt_dims_and_gated_searchers_equal_the_reference():
    for dom in (lambda t: t.loguniform(1e-4, 1e-1), lambda t: t.choice(["relu", "tanh", "gelu"]),
                lambda t: t.randint(2, 10), lambda t: t.quniform(0.0, 1.0, 0.1)):
        dj, dt = jbayesopt._Dim("k", dom(jtune)), tbayesopt._Dim("k", dom(ttune))
        us = [i / 16 for i in range(17)]
        assert [dt.from_unit(u) for u in us] == [dj.from_unit(u) for u in us]
        assert [dt.to_unit(dt.from_unit(u)) for u in us] == [dj.to_unit(dj.from_unit(u)) for u in us]
    for name, pkg in (("OptunaSearch", "optuna"), ("AxSearch", "ax-platform"), ("HyperOptSearch", "hyperopt")):
        with pytest.raises(ImportError, match=pkg):
            getattr(tsearch, name)()
    assert tsched.HyperBandForBOHB is tsched.HyperBandScheduler
    assert tsched.AsyncHyperBandScheduler is tsched.ASHAScheduler


# -- schedulers on one scripted sweep ----------------------------------------

class _Ctl:
    """What a scheduler reads of the TuneController: its trials, the default
    resources, and stop_trial."""

    def __init__(self, pkg, log):
        self.trials = []
        self.resources_per_trial = {"CPU": 1}
        self._pkg, self._log = pkg, log

    def stop_trial(self, trial):
        self._log.append(("stop_trial", trial.trial_id))
        trial.status = self._pkg["trial"].TERMINATED


def _sweep(pkg, make_scheduler, configs, max_iter, cap, metric="score", mode="max", steps=400):
    """A controller's loop without actors: trials start as the scheduler
    chooses them, up to ``cap`` at once; each running trial reports in turn
    (its score grows by its config's rate; a checkpoint after every result);
    each decision is applied as the controller applies it. Returns the log of
    starts, results, decisions, exploits and resizes."""
    T = pkg["trial"]
    sched = make_scheduler(pkg)
    sched.set_search_properties(metric, mode)
    log = []
    ctl = _Ctl(pkg, log)
    state = {}  # trial_id -> (iteration, score) the trainable holds
    for i, cfg in enumerate(configs):
        t = T.Trial(config=dict(cfg), trial_id=f"t{i}")
        ctl.trials.append(t)
        sched.on_trial_add(ctl, t)
        state[t.trial_id] = (0, 0.0)
    for _ in range(steps):
        while sum(t.status == T.RUNNING for t in ctl.trials) < cap:
            t = sched.choose_trial_to_run(ctl)
            if t is None and not any(x.status == T.RUNNING for x in ctl.trials):
                sched.on_no_available_trials(ctl)
                t = sched.choose_trial_to_run(ctl)
            if t is None:
                break
            t.status = T.RUNNING
            if t.checkpoint is not None:
                state[t.trial_id] = t.checkpoint
            log.append(("start", t.trial_id, t.resources))
        running = [t for t in ctl.trials if t.status == T.RUNNING]
        if not running:
            break
        for t in running:
            if t.status != T.RUNNING:
                continue
            it, score = state[t.trial_id]
            it, score = it + 1, score + float(t.config["rate"])
            state[t.trial_id] = (it, score)
            result = {"training_iteration": it, metric: score if mode == "max" else -score}
            t.last_result = {**t.last_result, **result}
            if it >= max_iter:
                sched.on_trial_complete(ctl, t, t.last_result)
                t.status = T.TERMINATED
                log.append(("done", t.trial_id, it))
                continue
            decision = sched.on_trial_result(ctl, t, t.last_result)
            log.append(("result", t.trial_id, it, result[metric], decision))
            t.checkpoint = (it, score)
            if decision == "STOP":
                sched.on_trial_complete(ctl, t, t.last_result)
                t.status = T.TERMINATED
            elif decision == "PAUSE":
                t.status = T.PAUSED
            elif decision == "EXPLOIT":
                donor, new_config = sched.pending_exploit.pop(t.trial_id)
                log.append(("exploit", t.trial_id, donor.trial_id, donor.checkpoint, new_config))
                t.config = new_config
                t.checkpoint = donor.checkpoint
                state[t.trial_id] = donor.checkpoint
    return log


def _rates(*rs):
    return [{"rate": r} for r in rs]


SCHEDULERS = {
    "asha": (lambda p: p["sched"].ASHAScheduler(max_t=20, grace_period=2, reduction_factor=2),
             _rates(10.0, 1.0, 0.1, 0.01, 5.0, 0.5), 20, 2, "max"),
    "asha_min": (lambda p: p["sched"].ASHAScheduler(max_t=9, grace_period=1, reduction_factor=3),
                 _rates(0.3, 3.0, 1.0, 0.1, 2.0, 0.2, 0.7, 1.5, 0.05), 9, 3, "min"),
    "hyperband": (lambda p: p["sched"].HyperBandScheduler(max_t=9, reduction_factor=3),
                  _rates(9.0, 3.0, 1.0, 0.3, 0.1, 0.03), 9, 3, "max"),
    "hyperband_wide": (lambda p: p["sched"].HyperBandScheduler(max_t=27, reduction_factor=3),
                       _rates(*[0.1 * (i % 7 + 1) for i in range(14)]), 27, 4, "max"),
    "median": (lambda p: p["sched"].MedianStoppingRule(grace_period=2, min_samples_required=2),
               _rates(0.001, 0.001, 5.0, 5.0, 2.0, 0.01), 20, 4, "max"),
    "pbt": (lambda p: p["sched"].PopulationBasedTraining(
        perturbation_interval=3, hyperparam_mutations={"rate": p["tune"].uniform(0.1, 10.0)}, seed=0),
        _rates(0.1, 0.2, 8.0, 7.0), 12, 4, "max"),
    "pbt_lists": (lambda p: p["sched"].PopulationBasedTraining(
        perturbation_interval=2, quantile_fraction=0.5, resample_probability=0.5,
        hyperparam_mutations={"rate": [0.5, 1.0, 2.0, 4.0]}, seed=3),
        _rates(0.5, 1.0, 2.0, 4.0, 1.0, 0.5), 10, 3, "min"),
    "pb2": (lambda p: p["sched"].PB2(
        perturbation_interval=3, hyperparam_mutations={"rate": p["tune"].uniform(0.1, 10.0)}, seed=0),
        _rates(0.1, 0.2, 8.0, 7.0), 12, 4, "max"),
    "pb2_long": (lambda p: p["sched"].PB2(
        perturbation_interval=2, quantile_fraction=0.5, hyperparam_mutations={"rate": [0.1, 10.0]}, seed=1),
        _rates(0.2, 0.5, 1.0, 3.0, 6.0, 9.0), 16, 6, "max"),
    "resource_changing": (lambda p: p["sched"].ResourceChangingScheduler(
        resources_allocation_function=lambda ctl, trial, result, sched: (
            {"CPU": 2} if result.get("training_iteration", 0) >= 2 else None)),
        _rates(1.0, 2.0), 6, 2, "max"),
    "resource_changing_default": (lambda p: p["sched"].ResourceChangingScheduler(
        base_scheduler=p["sched"].ASHAScheduler(max_t=8, grace_period=2, reduction_factor=2)),
        _rates(1.0, 2.0, 0.5), 8, 3, "max"),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_scheduler_decisions_equal_the_reference(name, monkeypatch):
    make, configs, max_iter, cap, mode = SCHEDULERS[name]
    # DistributeResources splits the cluster's CPUs: give both packages the
    # same 8-CPU cluster without booting one.
    for pkg in PKGS.values():
        monkeypatch.setattr(pkg["root"], "cluster_resources", lambda: {"CPU": 8})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = _sweep(PKGS["ref"], make, configs, max_iter, cap, mode=mode)
    port = _sweep(PKGS["port"], make, configs, max_iter, cap, mode=mode)
    assert port == ref
    decisions = {e[4] for e in port if e[0] == "result"}
    expected = {"asha": {"STOP"}, "asha_min": {"STOP"}, "hyperband": {"PAUSE", "STOP"},
                "hyperband_wide": {"PAUSE"}, "median": {"STOP"}, "pbt": {"EXPLOIT"},
                "pbt_lists": {"EXPLOIT"}, "pb2": {"EXPLOIT"}, "pb2_long": {"EXPLOIT"},
                "resource_changing": {"PAUSE"}, "resource_changing_default": {"PAUSE"}}[name]
    assert expected <= decisions, decisions
    if name.startswith("pb2"):
        # GP-guided explore stays inside the declared box.
        assert all(0.1 <= e[4]["rate"] <= 10.0 for e in port if e[0] == "exploit")
    if name == "pb2_long":
        # Enough intervals for the Gaussian process to have picked points.
        assert sum(e[0] == "exploit" for e in port) >= 3


# -- the Gaussian process against scikit-learn's -------------------------------

def _sklearn_gp(X, y, alpha):
    from sklearn.gaussian_process import GaussianProcessRegressor
    from sklearn.gaussian_process.kernels import ConstantKernel, Matern

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        gp = GaussianProcessRegressor(kernel=ConstantKernel(1.0) * Matern(nu=2.5), alpha=alpha,
                                      random_state=0).fit(X, y)
    return gp, [str(w.message) for w in caught]


def _bayesopt_quadratic():
    # The first 10 observations the reference's BayesOptSearch makes on
    # test_tune_extras.py's quadratic (x in [0, 6], best at 3), normalised
    # as the searcher does.
    searcher = SEARCHERS["bayesopt"](PKGS["ref"])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _drive_searcher(searcher, 10)
    x, y = np.asarray(searcher._X), np.asarray(searcher._y)
    return x, (y - y.mean()) / (y.std() + 1e-9), 1e-6


def _pb2_grow():
    # PB2 on test_tune_extras.py's _GrowTrainable: rates 0.1 and 8.0 (and
    # their mutations), reward deltas a rate.
    rates = np.array([0.1, 0.1, 8.0, 8.0, 0.1, 0.1, 8.0, 8.0, 9.6, 6.4])
    return ((rates - 0.1) / 9.9)[:, None], (rates - rates.mean()) / (rates.std() + 1e-9), 1e-4


def _duplicate_points():
    rng = np.random.default_rng(1)
    X = rng.random((6, 1))
    X[3] = X[1]
    X[5] = X[1]
    return X, rng.standard_normal(6), 1e-6


# Built in the test, not at collection: every worker of a parallel run
# collects the module.
GP_CASES = {
    "bayesopt_quadratic": _bayesopt_quadratic,
    "pb2_grow": _pb2_grow,
    "smooth_2d": lambda: (lambda X: (X, np.sin(6 * X).sum(1), 1e-6))(np.random.default_rng(2).random((12, 2))),
    "duplicate_points": _duplicate_points,
    "constant_y": lambda: (np.random.default_rng(3).random((6, 2)), np.full(6, 3.0), 1e-6),
    "zero_y": lambda: (np.random.default_rng(4).random((5, 3)), np.zeros(5), 1e-4),
    "single_point": lambda: (np.array([[0.5]]), np.array([1.0]), 1e-6),
}


@pytest.mark.parametrize("name", sorted(GP_CASES))
def test_gaussian_process_equals_sklearn(name):
    from scipy.stats import norm

    X, y, alpha = GP_CASES[name]()
    ref, caught = _sklearn_gp(X, y, alpha)
    port = GaussianProcess(alpha).fit(X, y)
    # θ = (log c, log l), compared as the values scikit-learn keeps.
    np.testing.assert_allclose(np.exp(port.theta), [ref.kernel_.k1.constant_value, ref.kernel_.k2.length_scale],
                               rtol=GP_RTOL, atol=0)
    cand = np.random.default_rng(7).random((256, X.shape[1]))
    mu_r, sd_r = ref.predict(cand, return_std=True)
    mu_p, sd_p = port.predict(cand)
    np.testing.assert_allclose(mu_p, mu_r, rtol=GP_RTOL, atol=GP_RTOL)
    np.testing.assert_allclose(sd_p, sd_r, rtol=GP_RTOL, atol=GP_RTOL)
    # The acquisitions pick the same candidate: BayesOptSearch's EI, PB2's UCB.
    best = y.max()

    def ei(mu, sd):
        imp = mu - best - 0.01
        z = imp / np.maximum(sd, 1e-9)
        return imp * norm.cdf(z) + sd * norm.pdf(z)

    assert int(np.argmax(ei(mu_p, sd_p))) == int(np.argmax(ei(mu_r, sd_r)))
    assert int(np.argmax(mu_p + 2.0 * sd_p)) == int(np.argmax(mu_r + 2.0 * sd_r))
    if name == "bayesopt_quadratic":
        # L-BFGS-B stops early here in both (scikit-learn warns "lbfgs failed
        # to converge ... ABNORMAL"); the port stops at the same θ.
        assert "ABNORMAL" in port.opt_result.message
        assert any("ABNORMAL" in m for m in caught), caught
