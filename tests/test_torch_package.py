"""ray_tpu_torch stands alone: no JAX, nothing of ray_tpu, no silent CPU path,
and its runtime never meets the JAX package's: no module path, environment
variable or session directory of one names the other's."""

import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "ray_tpu")


def test_import_pulls_in_no_jax_and_no_ray_tpu():
    code = (
        "import sys\n"
        "import ray_tpu_torch, ray_tpu_torch.models, ray_tpu_torch.ops.attention, "
        "ray_tpu_torch.ops.losses, ray_tpu_torch.ops._build, ray_tpu_torch.models.generate, "
        "ray_tpu_torch.serve, ray_tpu_torch.serve.llm, ray_tpu_torch._private.core_worker, "
        "ray_tpu_torch._private.worker_main, ray_tpu_torch._private.node, ray_tpu_torch.train.torch, "
        "ray_tpu_torch.train.flagship_loop, ray_tpu_torch.air.execution, ray_tpu_torch.parallel.mesh, "
        "ray_tpu_torch.parallel.ring_attention, ray_tpu_torch.parallel.ulysses, ray_tpu_torch.parallel.pipeline, "
        "ray_tpu_torch.parallel.multichip, ray_tpu_torch.train.torch.checkpointing, "
        "ray_tpu_torch.util.collective, ray_tpu_torch.util.collective.nccl_group, "
        "ray_tpu_torch.experimental.device_object, ray_tpu_torch.experimental.channel, "
        "ray_tpu_torch.dag, ray_tpu_torch.parallel.mpmd_pipeline, ray_tpu_torch.serve._private.controller, "
        "ray_tpu_torch.serve._private.http_proxy, ray_tpu_torch.serve.llm.kv_transfer, ray_tpu_torch.data, "
        "ray_tpu_torch.data.preprocessors, ray_tpu_torch.data.datasource.sql_datasource, "
        "ray_tpu_torch.data.datasource.webdataset_datasource, ray_tpu_torch.data.datasource.mongo_datasource, "
        "ray_tpu_torch.train.predictor, ray_tpu_torch.tune, ray_tpu_torch.rllib, ray_tpu_torch.rllib.offline, "
        "ray_tpu_torch.rllib.evaluation, ray_tpu_torch.rllib.connectors, ray_tpu_torch.rllib.models, "
        "ray_tpu_torch.rllib.utils, ray_tpu_torch.rllib.env, ray_tpu_torch.rllib.algorithms.pg.pg, "
        "ray_tpu_torch.rllib.algorithms.a2c.a2c, ray_tpu_torch.rllib.algorithms.a3c.a3c, "
        "ray_tpu_torch.rllib.algorithms.ddppo.ddppo, ray_tpu_torch.rllib.algorithms.dqn.dqn, "
        "ray_tpu_torch.rllib.algorithms.simple_q.simple_q, ray_tpu_torch.rllib.algorithms.apex_dqn.apex_dqn, "
        "ray_tpu_torch.rllib.algorithms.r2d2.r2d2, ray_tpu_torch.rllib.algorithms.off_policy, "
        "ray_tpu_torch.rllib.algorithms.sac.sac, ray_tpu_torch.rllib.algorithms.ddpg.ddpg, "
        "ray_tpu_torch.rllib.algorithms.cql.cql, ray_tpu_torch.rllib.algorithms.crr.crr, "
        "ray_tpu_torch.rllib.algorithms.apex_ddpg.apex_ddpg, ray_tpu_torch.rllib.algorithms.maddpg.maddpg, "
        "ray_tpu_torch.rllib.env.pendulum, ray_tpu_torch.rllib.env.multi_agent_env, "
        "ray_tpu_torch.rllib.env.meta_env, ray_tpu_torch.rllib.algorithms.maml.maml, "
        "ray_tpu_torch.rllib.algorithms.mbmpo.mbmpo, ray_tpu_torch.rllib.algorithms.dreamerv3.dreamerv3, "
        "ray_tpu_torch.rllib.algorithms.alpha_zero.alpha_zero, "
        "ray_tpu_torch.rllib.algorithms.leela_chess_zero.leela_chess_zero, "
        "ray_tpu_torch.rllib.algorithms.alpha_star.alpha_star, ray_tpu_torch.rllib.env.board_env, "
        "ray_tpu_torch.rllib.env.two_player, ray_tpu_torch.rllib.env.external_env, "
        "ray_tpu_torch.rllib.env.policy_server, ray_tpu_torch.rllib.train, ray_tpu_torch.tune.tuner, "
        "ray_tpu_torch.tune.execution.tune_controller, ray_tpu_torch.tune.search, ray_tpu_torch.tune.schedulers, "
        "ray_tpu_torch.tune.search._gp, ray_tpu_torch.tune.analysis, ray_tpu_torch.tune.logger, "
        "ray_tpu_torch.tune.syncer\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_source_imports_jax_or_ray_tpu():
    files = sorted((ROOT / "ray_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 5
    names = {p.relative_to(ROOT).as_posix() for p in files}
    for module in ("parallel/mesh.py", "parallel/ring_attention.py", "parallel/ulysses.py", "parallel/pipeline.py",
                   "parallel/multichip.py", "train/torch/checkpointing.py", "models/transformer.py", "air/session.py",
                   "util/collective/collective.py", "util/collective/cpu_group.py", "util/collective/p2p.py",
                   "util/collective/nccl_group.py", "util/collective/types.py",
                   "experimental/device_object/manager.py", "experimental/device_object/resolve.py",
                   "experimental/device_object/descriptor.py", "experimental/channel/channel.py",
                   "experimental/channel/device_envelope.py", "experimental/channel/resident_loop.py",
                   "dag/dag_node.py", "dag/compiled.py", "parallel/mpmd_pipeline.py", "serve/api.py",
                   "serve/_private/controller.py", "serve/_private/asgi.py", "serve/llm/kv_transfer.py",
                   "serve/llm/deployment.py", "data/block.py", "data/context.py", "data/_internal/logical_plan.py",
                   "data/_internal/stats.py", "data/_internal/executor.py", "data/_internal/shuffle.py",
                   "data/aggregate.py", "data/grouped_data.py", "data/dataset.py", "data/iterator.py",
                   "data/dataset_pipeline.py", "data/datasource/datasource.py", "data/datasource/partitioning.py",
                   "data/datasource/sql_datasource.py", "data/datasource/webdataset_datasource.py",
                   "data/datasource/mongo_datasource.py", "data/read_api.py", "data/__init__.py",
                   "data/preprocessor.py", "data/preprocessors/__init__.py", "data/preprocessors/extended.py",
                   "train/predictor.py", "tune/__init__.py", "tune/trainable.py", "rllib/__init__.py",
                   "rllib/core/rl_module.py", "rllib/core/learner.py", "rllib/evaluation/rollout_worker.py",
                   "rllib/algorithms/algorithm.py", "rllib/algorithms/ppo/ppo.py", "rllib/algorithms/impala/impala.py",
                   "rllib/algorithms/appo/appo.py", "rllib/algorithms/dt/dt.py", "rllib/utils/vtrace.py",
                   "rllib/policy/policy.py", "rllib/policy/sample_batch.py", "rllib/offline/__init__.py",
                   "rllib/offline/estimators.py", "rllib/env/cartpole.py", "rllib/env/spaces.py",
                   "rllib/env/vector_env.py", "rllib/connectors/connector.py", "rllib/models/__init__.py",
                   "rllib/algorithms/pg/pg.py", "rllib/algorithms/a2c/a2c.py", "rllib/algorithms/a3c/a3c.py",
                   "rllib/algorithms/ddppo/ddppo.py", "rllib/algorithms/dqn/dqn.py",
                   "rllib/algorithms/simple_q/simple_q.py", "rllib/algorithms/apex_dqn/apex_dqn.py",
                   "rllib/algorithms/r2d2/r2d2.py", "rllib/algorithms/off_policy.py", "rllib/algorithms/sac/sac.py",
                   "rllib/algorithms/ddpg/ddpg.py", "rllib/algorithms/cql/cql.py", "rllib/algorithms/crr/crr.py",
                   "rllib/algorithms/apex_ddpg/apex_ddpg.py", "rllib/algorithms/maddpg/maddpg.py",
                   "rllib/env/pendulum.py", "rllib/env/multi_agent_env.py", "rllib/env/meta_env.py",
                   "rllib/algorithms/maml/maml.py", "rllib/algorithms/mbmpo/mbmpo.py",
                   "rllib/algorithms/dreamerv3/dreamerv3.py", "rllib/algorithms/alpha_zero/alpha_zero.py",
                   "rllib/algorithms/leela_chess_zero/leela_chess_zero.py", "rllib/algorithms/alpha_star/alpha_star.py",
                   "rllib/env/board_env.py", "rllib/env/two_player.py", "rllib/env/external_env.py",
                   "rllib/env/policy_server.py", "rllib/train.py", "rllib/__main__.py", "tune/sample.py",
                   "tune/experiment/trial.py", "tune/search/searcher.py", "tune/search/basic_variant.py",
                   "tune/search/repeater.py", "tune/schedulers/trial_scheduler.py", "tune/schedulers/asha.py",
                   "tune/schedulers/median_stopping.py", "tune/schedulers/hyperband.py", "tune/schedulers/pbt.py",
                   "tune/logger.py", "tune/syncer.py", "tune/execution/tune_controller.py", "tune/tune_config.py",
                   "tune/result_grid.py", "tune/tuner.py", "tune/analysis/experiment_analysis.py",
                   "tune/search/hyperopt_like.py", "tune/search/gated.py", "tune/search/_gp.py",
                   "tune/search/bayesopt.py", "tune/search/bohb.py", "tune/schedulers/pb2.py",
                   "tune/schedulers/resource_changing.py"):
        assert f"ray_tpu_torch/{module}" in names, module
    for path in files:
        bad = _imported_roots(path) & set(FORBIDDEN)
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_serve_imports_no_http_or_schema_package():
    """The serve plane stands on the standard library: its HTTP server is
    asyncio's (no aiohttp) and it has no pydantic schema (the ``serve
    deploy`` CLI is not ported)."""
    files = sorted((ROOT / "ray_tpu_torch" / "serve").rglob("*.py"))
    names = {p.relative_to(ROOT / "ray_tpu_torch" / "serve").as_posix() for p in files}
    for module in ("api.py", "batching.py", "multiplex.py", "handle.py", "_private/common.py", "_private/router.py",
                   "_private/replica.py", "_private/controller.py", "_private/asgi.py", "_private/http_proxy.py",
                   "llm/engine.py", "llm/stats.py", "llm/kv_transfer.py", "llm/deployment.py"):
        assert module in names, module
    for path in files:
        bad = _imported_roots(path) & {"aiohttp", "pydantic", "uvicorn", "starlette", "fastapi"}
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"
    code = (
        "import sys\n"
        "import ray_tpu_torch.serve, ray_tpu_torch.serve.llm, ray_tpu_torch.serve._private.controller, "
        "ray_tpu_torch.serve._private.http_proxy, ray_tpu_torch.serve._private.asgi\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in ('aiohttp', 'pydantic')))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_data_and_predictors_need_neither_pyarrow_nor_pandas():
    """The card's machine has neither package: no module of the port imports
    one at module level, and the data package and the predictors import and
    move numpy blocks with both blocked."""
    for path in sorted((ROOT / "ray_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
        names = {a.name.split(".")[0] for n in top if isinstance(n, ast.Import) for a in n.names}
        names |= {n.module.split(".")[0] for n in top if isinstance(n, ast.ImportFrom) and n.module and not n.level}
        assert not names & {"pyarrow", "pandas"}, f"{path.relative_to(ROOT)} imports {sorted(names)}"
    code = (
        "import sys\n"
        "for name in ('pyarrow', 'pandas'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np\n"
        "import ray_tpu_torch.data as rd, ray_tpu_torch.data.preprocessors, ray_tpu_torch.train.predictor\n"
        "from ray_tpu_torch.data.block import BlockAccessor\n"
        "block = BlockAccessor.batch_to_block([{'a': 1, 'x': np.ones(3)}, {'a': 2, 'x': np.zeros(3)}])\n"
        "acc = BlockAccessor(block)\n"
        "assert acc.num_rows() == 2 and acc.schema().shapes == ((), (3,))\n"
        "assert acc.to_batch('numpy')['a'].tolist() == [1, 2]\n"
        "try:\n"
        "    acc.to_batch('pandas')\n"
        "except ImportError as e:\n"
        "    print(e)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "batch_format=\"pandas\" needs the 'pandas' package, which is not installed"


def test_rllib_needs_no_gymnasium():
    """The card's machine need not have gymnasium: no module of the port
    imports it at module level, and with it blocked RLlib imports, builds its
    own CartPole-v1, Pendulum-v1, PointGoalEnv (its tensor reward and
    dynamics), SlateRecEnv and its spaces, builds DreamerV3, MBMPO and SlateQ
    on them, imports the ES, ARS, QMIX, MARWIL and bandit modules, builds
    TicTacToeEnv, TwoPlayerMatrixEnv and AlphaZero on CartPole-v1 (one
    iteration), imports the external-env, policy-server and CLI modules, and
    names the package for any other env id."""
    for path in sorted((ROOT / "ray_tpu_torch").rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
        names = {a.name.split(".")[0] for n in top if isinstance(n, ast.Import) for a in n.names}
        names |= {n.module.split(".")[0] for n in top if isinstance(n, ast.ImportFrom) and n.module and not n.level}
        assert "gymnasium" not in names and "gym" not in names, path.relative_to(ROOT)
    code = (
        "import sys\n"
        "sys.modules['gymnasium'] = None\n"
        "import ray_tpu_torch.rllib\n"
        "from ray_tpu_torch.rllib.core.rl_module import RLModuleSpec\n"
        "from ray_tpu_torch.rllib.env import make\n"
        "env = make('CartPole-v1')\n"
        "obs, _ = env.reset(seed=0)\n"
        "spec = RLModuleSpec.from_spaces(env.observation_space, env.action_space)\n"
        "assert obs.shape == (4,) and spec.action_dim == 2 and spec.discrete\n"
        "env = make('Pendulum-v1')\n"
        "obs, _ = env.reset(seed=0)\n"
        "spec = RLModuleSpec.from_spaces(env.observation_space, env.action_space)\n"
        "assert obs.shape == (3,) and spec.action_dim == 1 and not spec.discrete\n"
        "import torch\n"
        "from ray_tpu_torch.rllib import DreamerV3Config, MBMPOConfig\n"
        "from ray_tpu_torch.rllib.env import PointGoalEnv\n"
        "env = PointGoalEnv({'seed': 0})\n"
        "obs, _ = env.reset()\n"
        "env.set_task(env.sample_tasks(1)[0])\n"
        "spec = RLModuleSpec.from_spaces(env.observation_space, env.action_space)\n"
        "assert spec.action_dim == 2 and not spec.discrete and env.step(obs)[3] is False\n"
        "nxt = PointGoalEnv.transition_fn(torch.zeros(1, 2), torch.ones(1, 2))\n"
        "assert PointGoalEnv.reward_fn(None, None, nxt, torch.as_tensor(env.get_task())).shape == (1,)\n"
        "algo = DreamerV3Config().environment('Pendulum-v1').resources(device='cpu').build()\n"
        "algo.cleanup()\n"
        "algo = MBMPOConfig().environment(PointGoalEnv).resources(device='cpu').build()\n"
        "algo.cleanup()\n"
        "from ray_tpu_torch.rllib import SlateQConfig\n"
        "from ray_tpu_torch.rllib.env import SlateRecEnv\n"
        "import ray_tpu_torch.rllib.algorithms.es.es, ray_tpu_torch.rllib.algorithms.ars.ars\n"
        "import ray_tpu_torch.rllib.algorithms.qmix.qmix, ray_tpu_torch.rllib.algorithms.marwil.marwil\n"
        "import ray_tpu_torch.rllib.algorithms.bandits.bandits\n"
        "algo = SlateQConfig().environment(SlateRecEnv).resources(device='cpu').build()\n"
        "assert len(algo.compute_single_action(algo.env.reset(seed=0)[0])) == 2\n"
        "algo.cleanup()\n"
        "from ray_tpu_torch.rllib import AlphaZeroConfig\n"
        "from ray_tpu_torch.rllib.env.board_env import TicTacToeEnv\n"
        "from ray_tpu_torch.rllib.env.two_player import TwoPlayerMatrixEnv\n"
        "import ray_tpu_torch.rllib.env.external_env, ray_tpu_torch.rllib.env.policy_server, ray_tpu_torch.rllib.train\n"
        "board = TicTacToeEnv()\n"
        "assert board.reset().shape == (9,) and board.legal_actions().all() and int(board.action_space.n) == 9\n"
        "pair = TwoPlayerMatrixEnv({'rounds': 2})\n"
        "assert pair.reset()[0].shape == (6,) and pair.step(0, 2)[2] == 1.0 and int(pair.action_space.n) == 3\n"
        "algo = AlphaZeroConfig().environment('CartPole-v1').training(num_sims=4, episodes_per_iter=1, "
        "updates_per_iter=1, horizon=20).resources(device='cpu').build()\n"
        "assert algo.step()['timesteps_total'] > 0\n"
        "algo.cleanup()\n"
        "try:\n"
        "    make('Acrobot-v1')\n"
        "except ImportError as e:\n"
        "    print(e)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ("env 'Acrobot-v1' needs the 'gymnasium' package, which is not installed "
                                  "(the port carries its own ['CartPole-v1', 'Pendulum-v1'] only)")


def test_rllib_exports_exactly_the_ported_algorithms():
    """ray_tpu_torch.rllib names every ported algorithm with its config: all
    30 algorithm directories of the JAX package's RLlib are ported, and the
    external-env and policy-server classes are exported where the
    reference's are."""
    import ray_tpu_torch.rllib as trl
    import ray_tpu_torch.rllib.env as tenv
    from ray_tpu_torch.rllib.train import available_algorithms

    ported = ["A2C", "A3C", "APPO", "ARS", "AlphaStar", "AlphaZero", "ApexDDPG", "ApexDQN", "BC", "CQL", "CRR",
              "DDPG", "DDPPO", "DQN", "DT", "DreamerV3", "ES", "IMPALA", "LeelaChessZero", "MADDPG", "MAML", "MARWIL",
              "MBMPO", "PG", "PPO", "QMIX", "R2D2", "SAC", "SimpleQ", "SlateQ", "TD3"]
    dirs = sorted(p.name for p in (ROOT / "ray_tpu" / "rllib" / "algorithms").iterdir()
                  if p.is_dir() and (p / "__init__.py").exists())
    assert len(dirs) == 30
    for name in dirs:
        assert (ROOT / "ray_tpu_torch" / "rllib" / "algorithms" / name / "__init__.py").exists(), name
    configs = sorted(n[: -len("Config")] for n in dir(trl) if n.endswith("Config") and n != "AlgorithmConfig")
    assert configs == sorted(ported + ["Bandit"])
    for name in ported:
        assert issubclass(getattr(trl, name), trl.Algorithm)
        assert getattr(trl, f"{name}Config")().algo_class is getattr(trl, name)
    # The two bandits share one config class, as in the JAX package.
    assert issubclass(trl.BanditLinTS, trl.BanditLinUCB) and issubclass(trl.BanditLinUCB, trl.Algorithm)
    assert trl.BanditConfig().algo_class is trl.BanditLinUCB
    assert trl.BanditLinTS.get_default_config().algo_class is trl.BanditLinTS
    assert trl.MultiAgentEnv is trl.env.multi_agent_env.MultiAgentEnv and callable(trl.make_multi_agent)
    assert trl.ExternalEnv is tenv.ExternalEnv and trl.ExternalEnvRunner is tenv.ExternalEnvRunner
    assert tenv.PolicyClient.__module__ == "ray_tpu_torch.rllib.env.policy_server"
    assert tenv.PolicyServerInput.__module__ == "ray_tpu_torch.rllib.env.policy_server"
    assert available_algorithms() == sorted(ported + ["BanditLinTS", "BanditLinUCB"])


def test_tune_exports_the_references_names_and_needs_no_sklearn_pandas_or_tensorboardx():
    """ray_tpu_torch.tune, its schedulers and its searchers export what the
    JAX package's do; every module of tune/ in the JAX package has its
    counterpart at the same path. The card's machine has no scikit-learn,
    pandas or tensorboardX: with all three blocked Tune imports, its
    Gaussian process fits and predicts, the TensorBoard logger is skipped
    quietly and the dataframe views raise ImportError naming pandas."""
    import ray_tpu.tune as jtune
    import ray_tpu_torch.tune as ttune
    from ray_tpu.tune import schedulers as jsched
    from ray_tpu.tune import search as jsearch
    from ray_tpu_torch.tune import schedulers as tsched
    from ray_tpu_torch.tune import search as tsearch

    for ref, port in ((jtune, ttune), (jsched, tsched), (jsearch, tsearch)):
        public = lambda m: sorted(n for n in dir(m) if not n.startswith("_") and not isinstance(getattr(m, n), type(m)))
        assert public(port) == public(ref), port.__name__
    for name in ("Tuner", "run", "report", "get_checkpoint", "choice", "uniform", "loguniform", "randint",
                 "grid_search", "sample_from", "TuneConfig", "ResultGrid", "ExperimentAnalysis", "FunctionTrainable"):
        assert hasattr(ttune, name), name
    for name in ("ASHAScheduler", "HyperBandScheduler", "MedianStoppingRule", "PopulationBasedTraining", "PB2",
                 "ResourceChangingScheduler"):
        assert issubclass(getattr(tsched, name), tsched.TrialScheduler), name
    for name in ("BasicVariantGenerator", "BayesOptSearch", "TuneBOHB", "HyperOptLikeSearch", "Repeater",
                 "ConcurrencyLimiter"):
        assert issubclass(getattr(tsearch, name), tsearch.Searcher), name
    ref_files = {p.relative_to(ROOT / "ray_tpu" / "tune").as_posix() for p in (ROOT / "ray_tpu" / "tune").rglob("*.py")}
    for rel in ref_files:
        assert (ROOT / "ray_tpu_torch" / "tune" / rel).exists(), rel
    code = (
        "import sys\n"
        "for name in ('sklearn', 'pandas', 'tensorboardX'):\n"
        "    sys.modules[name] = None\n"
        "import tempfile\n"
        "import numpy as np\n"
        "import ray_tpu_torch.tune as tune\n"
        "from ray_tpu_torch.tune.logger import LoggerManager\n"
        "from ray_tpu_torch.tune.experiment.trial import Trial\n"
        "from ray_tpu_torch.tune.search._gp import GaussianProcess\n"
        "X = np.linspace(0, 1, 6)[:, None]\n"
        "mu, sd = GaussianProcess(1e-6).fit(X, np.sin(6 * X[:, 0])).predict(X)\n"
        "assert mu.shape == sd.shape == (6,) and np.all(sd >= 0)\n"
        "d = tempfile.mkdtemp()\n"
        "m = LoggerManager(d)\n"
        "m.on_result(Trial(config={'a': 1}, trial_id='t'), {'score': 1.0})\n"
        "m.close()\n"
        "import os\n"
        "assert sorted(os.listdir(os.path.join(d, 't'))) == ['params.json', 'progress.csv', 'result.json']\n"
        "try:\n"
        "    tune.ResultGrid([]).get_dataframe()\n"
        "except ImportError as e:\n"
        "    print(e)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "pandas not available"


def test_worker_runtime_imports_no_torch():
    """The zygote forks workers after importing the worker runtime; torch (and
    with it any CUDA state) must stay out of that process until a task needs
    it."""
    code = (
        "import sys\n"
        "import ray_tpu_torch, ray_tpu_torch._private.core_worker, ray_tpu_torch._private.worker_context, "
        "ray_tpu_torch._private.worker_main, ray_tpu_torch._private.zygote, ray_tpu_torch.util.tracing\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] == 'torch'))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# The one variable of the JAX package's name the port reads: a debug switch
# that carries no state (the thread-affinity asserts of _private/concurrency.py).
SHARED_ENV = {"RAY_TPU_DEBUG_AFFINITY"}


def _foreign_names(text: str) -> list[str]:
    """What in one string literal names the JAX package's runtime or a path
    that two runtimes would share: a ``ray_tpu.`` module path, a ``RAY_TPU_``
    variable without the port's ``RAY_TPU_TORCH_`` prefix (bar SHARED_ENV),
    or a fixed ``/tmp/`` or ``/dev/shm/`` path (the port roots what it writes
    under ``tempfile.gettempdir()``, so a TMPDIR keeps two checkouts apart)."""
    found = re.findall(r"\bray_tpu\.[\w.]*", text)
    found += [v for v in re.findall(r"RAY_TPU_\w*", text) if not v.startswith("RAY_TPU_TORCH_") and v not in SHARED_ENV]
    found += re.findall(r"/(?:tmp|dev/shm)(?:/|$)\S*", text)
    return found


def test_no_string_names_the_jax_runtime():
    """Worker argv (``-m ...worker_main``), importlib paths, environment
    variables and session paths are strings the import scan cannot see."""
    files = sorted((ROOT / "ray_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    bad = []
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                bad += [f"{path.relative_to(ROOT)}:{node.lineno}: {n}" for n in _foreign_names(node.value)]
    assert not bad, "\n".join(bad)


@pytest.mark.parametrize("text,names", [
    ("-m ray_tpu._private.worker_main", ["ray_tpu._private.worker_main"]),
    ("-m ray_tpu_torch._private.worker_main", []),
    ("RAY_TPU_GCS_ADDR", ["RAY_TPU_GCS_ADDR"]),
    ("RAY_TPU_TORCH_GCS_ADDR RAY_TPU_DEBUG_AFFINITY", []),
    ("/tmp/ray_tpu/session_1", ["/tmp/ray_tpu/session_1"]),
    ("/tmp/ray_tpu_torch/session_1", ["/tmp/ray_tpu_torch/session_1"]),
    ("/dev/shm/ray_tpu_torch_flight", ["/dev/shm/ray_tpu_torch_flight"]),
    ("ray_tpu_torch/results", []),
])
def test_the_string_scan_sees_each_kind(text, names):
    assert _foreign_names(text) == names


def test_entry_points_raise_without_a_card():
    from ray_tpu_torch.models import TransformerConfig, adamw, init_params, make_train_step
    from ray_tpu_torch.models.generate import init_cache, init_paged_cache

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card path cannot be exercised")
    cfg = TransformerConfig(vocab_size=64, d_model=32, n_layers=1, n_heads=1, n_kv_heads=1, d_ff=64)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(cfg, adamw(params))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_paged_cache(cfg, 4, 4)

    # The trainer: the default ScalingConfig asks for a card, and fit() raises
    # before it starts a worker (it never trains on the CPU).
    import ray_tpu_torch as rt
    from ray_tpu_torch.train.flagship_loop import train_loop
    from ray_tpu_torch.train.torch import TorchTrainer

    # Checkpoints restore onto the card unless asked for the CPU, and outside
    # a train session the worker's device is the card: both raise here.
    from ray_tpu_torch.air.checkpoint import checkpoint_from_tensors, tensors_from_checkpoint
    from ray_tpu_torch.train.torch import get_device, prepare_batch

    ckpt = checkpoint_from_tensors({"w": torch.ones(2)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tensors_from_checkpoint(ckpt)
    assert tensors_from_checkpoint(ckpt, device="cpu")["w"].device.type == "cpu"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        get_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prepare_batch({"x": [1.0]})

    # RLlib: the learner, the learner group, an Algorithm (before it starts a
    # rollout worker), the Decision Transformer and a Policy run on the card
    # unless asked for the CPU.
    from ray_tpu_torch.rllib import (
        A3CConfig,
        ApexDQNConfig,
        DDPPOConfig,
        DQNConfig,
        DTConfig,
        PPOConfig,
        Policy,
        R2D2Config,
    )
    from ray_tpu_torch.rllib.algorithms.ppo.ppo import ppo_loss
    from ray_tpu_torch.rllib.core import Learner, LearnerGroup, RLModuleSpec
    from ray_tpu_torch.rllib.env import Box, Discrete

    spec = RLModuleSpec(obs_dim=4, action_dim=2, discrete=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Learner(spec, ppo_loss)
    assert Learner(spec, ppo_loss, device="cpu").module.device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LearnerGroup(spec, ppo_loss)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PPOConfig().environment("CartPole-v1").build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DTConfig().environment("CartPole-v1").offline_data("unused").build()
    # The Q-learners and A3C's apply step hold their weights on the card;
    # DD-PPO's acting module is there (its workers learn on the CPU).
    for config in (DQNConfig, R2D2Config, ApexDQNConfig, A3CConfig, DDPPOConfig):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            config().environment("CartPole-v1").build()
    # The continuous family: parameters, targets, updates and the acting
    # forward on the card; each raises before it makes an env, reads data or
    # starts an explorer.
    from ray_tpu_torch.rllib import (
        ApexDDPGConfig,
        CQLConfig,
        CRRConfig,
        DDPGConfig,
        MADDPGConfig,
        MultiAgentEnv,
        SACConfig,
        TD3Config,
    )

    class TwoAgents(MultiAgentEnv):
        possible_agents = ["a", "b"]
        observation_space = Box(-1.0, 1.0, (2,))
        action_space = Box(-1.0, 1.0, (1,))

        def __init__(self, config=None):
            pass

    for config in (SACConfig, DDPGConfig, TD3Config, ApexDDPGConfig):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            config().environment("Pendulum-v1").build()
    for config in (CQLConfig, CRRConfig):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            config().environment("Pendulum-v1").offline_data(input_="unused").build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MADDPGConfig().environment(TwoAgents).build()
    # The model-based and meta-learning family: the world model, the
    # meta-policy and the dynamics ensemble on the card; each raises before
    # it makes an env or starts a rollout actor.
    from ray_tpu_torch.rllib import DreamerV3Config, MAMLConfig, MBMPOConfig
    from ray_tpu_torch.rllib.env import PointGoalEnv

    with pytest.raises(RuntimeError, match="device='cpu'"):
        DreamerV3Config().environment("Pendulum-v1").build()
    for config in (MAMLConfig, MBMPOConfig):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            config().environment(PointGoalEnv).build()
    # The lighter algorithms: MARWIL's and BC's learner, QMIX's and SlateQ's
    # networks and the acting forward of ES and ARS on the card; each raises
    # before it reads data, makes an env or starts a worker actor. The
    # bandits are numpy on the host and take no device.
    from ray_tpu_torch.rllib import (
        ARSConfig,
        BanditLinUCB,
        BCConfig,
        ESConfig,
        MARWILConfig,
        QMIXConfig,
        SlateQConfig,
    )
    from ray_tpu_torch.rllib.env import SlateRecEnv

    for config in (MARWILConfig, BCConfig):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            config().environment("CartPole-v1").offline_data(input_="unused").build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        QMIXConfig().environment(TwoAgents).build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SlateQConfig().environment(SlateRecEnv).build()
    for config in (ESConfig, ARSConfig):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            config().environment("CartPole-v1").build()

    class OneArm:
        observation_space = Box(-1.0, 1.0, (2,))
        action_space = Discrete(2)

        def __init__(self, config=None):
            pass

        def reset(self, *, seed=None):
            return [0.0, 0.0], {}

        def close(self):
            pass

    BanditLinUCB.get_default_config().environment(OneArm).build().cleanup()
    # The MCTS family: AlphaZero's and LC0's networks and AlphaStar's league on
    # the card; each raises before it makes an env.
    from ray_tpu_torch.rllib import AlphaStarConfig, AlphaZeroConfig, LeelaChessZeroConfig
    from ray_tpu_torch.rllib.env.board_env import TicTacToeEnv
    from ray_tpu_torch.rllib.env.two_player import TwoPlayerMatrixEnv

    with pytest.raises(RuntimeError, match="device='cpu'"):
        AlphaZeroConfig().environment("CartPole-v1").build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LeelaChessZeroConfig().environment(TicTacToeEnv).build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AlphaStarConfig().environment(TwoPlayerMatrixEnv).build()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Policy.from_spaces(Box(-1.0, 1.0, (4,)), Discrete(2))

    rt.init(num_cpus=1, object_store_memory=64 * 1024 * 1024)
    try:
        with pytest.raises(RuntimeError, match="needs 1 GPU"):
            TorchTrainer(train_loop, train_loop_config={}).fit()
        assert rt._global_node.raylet.workers == {}
    finally:
        rt.shutdown()
