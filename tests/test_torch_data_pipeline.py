"""The port's pipelines, partitioned reads, datasources, preprocessors and
predictors (``ray_tpu_torch.data``, ``ray_tpu_torch.train.predictor``) on
the CPU.

Every case of ``tests/test_data_pipeline.py``, ``test_data_partitioning.py``
and ``test_preprocessors.py`` with the reference's own assertions
(``test_jax_predictor_and_batch_predictor`` becomes the same case on
``TorchPredictor`` with ``device="cpu"``). ``read_parquet`` and
``to_pandas`` use pyarrow and pandas, which the test environment has; one
case hides each package (``sys.modules``) and checks that every call that
needs it raises ``ImportError`` naming the package and the call. A chain of fitted
preprocessors gives the reference's rows on the same seeded data.

One port cluster (4 CPUs: the reference files' clusters split these inputs
the same way) and one JAX cluster for the parity case; ~25 s here.
"""

import os
import sys

import numpy as np
import pytest

import ray_tpu_torch as rt
import ray_tpu_torch.data as rd
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.data import Partitioning
from ray_tpu_torch.data.preprocessor import PreprocessorNotFittedError
from ray_tpu_torch.data.preprocessors import (
    BatchMapper,
    Chain,
    Concatenator,
    LabelEncoder,
    MinMaxScaler,
    OneHotEncoder,
    SimpleImputer,
    StandardScaler,
)
from ray_tpu_torch.train import BatchPredictor, TorchPredictor


@pytest.fixture(scope="module")
def ray_cluster():
    rt.init(num_cpus=4, object_store_memory=256 * 1024 * 1024)
    try:
        yield
    finally:
        rt.shutdown()


# ---------------------------------------------------------------------------
# tests/test_data_pipeline.py's cases
# ---------------------------------------------------------------------------


def test_window_groups_blocks_and_preserves_rows(ray_cluster):
    ds = rd.range(100, parallelism=10)
    pipe = ds.window(blocks_per_window=4)
    windows = list(pipe.iter_datasets())
    assert len(windows) == 3
    assert [w.num_blocks() for w in windows] == [4, 4, 2]
    rows = [r["id"] for w in windows for r in w.iter_rows()]
    assert sorted(rows) == list(range(100))
    assert ds._cached_bundles is None


def test_window_transforms_apply_per_window(ray_cluster):
    pipe = (
        rd.range(40, parallelism=8)
        .window(blocks_per_window=2)
        .map_batches(lambda b: {"id": b["id"] * 2})
    )
    rows = sorted(r["id"] for r in pipe.iter_rows())
    assert rows == [2 * i for i in range(40)]


def test_repeat_reexecutes_lazy_plan_per_epoch(ray_cluster):
    calls = []

    def tag(batch):
        calls.append(len(batch["id"]))
        return batch

    ds = rd.range(30, parallelism=3).map_batches(tag)
    pipe = ds.repeat(3)
    epochs = list(pipe.iter_epochs())
    assert len(epochs) == 3
    for ep in epochs:
        got = sorted(r["id"] for r in ep.iter_rows())
        assert got == list(range(30))
    assert ds._cached_bundles is None


def test_window_repeat_three_epoch_train_ingest(ray_cluster):
    ds = rd.range(64, parallelism=8)
    pipe = ds.window(blocks_per_window=2).repeat(3)
    epoch_sums = []
    for epoch_ds in pipe.iter_epochs():
        total = 0
        n = 0
        for batch in epoch_ds.iter_batches(batch_size=16):
            total += int(np.sum(batch["id"]))
            n += len(batch["id"])
        assert n == 64
        epoch_sums.append(total)
    assert epoch_sums == [sum(range(64))] * 3
    assert ds._cached_bundles is None
    # The device feed over the same pipeline (the CPU here).
    torch_sums = [sum(int(b["id"].sum()) for b in ep.iter_torch_batches(batch_size=16, device="cpu"))
                  for ep in pipe.iter_epochs()]
    assert torch_sums == [sum(range(64))] * 3


def test_repeat_forever_is_lazy(ray_cluster):
    pipe = rd.range(10, parallelism=2).repeat()
    it = pipe.iter_rows()
    first = [next(it) for _ in range(25)]
    assert [r["id"] for r in first[:10]] == list(range(10))
    assert [r["id"] for r in first[20:25]] == list(range(5))


def test_pipeline_arg_validation(ray_cluster):
    ds = rd.range(10, parallelism=2)
    with pytest.raises(ValueError):
        ds.window(blocks_per_window=0)
    with pytest.raises(ValueError):
        ds.repeat(0)
    with pytest.raises(ValueError):
        ds.repeat(2).repeat(2)


# ---------------------------------------------------------------------------
# tests/test_data_partitioning.py's cases
# ---------------------------------------------------------------------------


def _write_hive_tree(base):
    import pyarrow as pa
    import pyarrow.parquet as pq

    rows = 0
    for year in (2023, 2024):
        for country in ("fr", "de"):
            d = os.path.join(base, f"year={year}", f"country={country}")
            os.makedirs(d)
            n = 5 if year == 2023 else 3
            pq.write_table(pa.table({"x": list(range(n))}), os.path.join(d, "part-0.parquet"))
            rows += n
    return rows


def test_hive_partitioning_adds_columns(ray_cluster, tmp_path):
    base = str(tmp_path / "tree")
    total = _write_hive_tree(base)
    part = Partitioning("hive", base_dir=base, field_types={"year": int})
    ds = rd.read_parquet(base, partitioning=part)
    df = ds.to_pandas()
    assert len(df) == total
    assert set(df.columns) >= {"x", "year", "country"}
    assert set(df["year"].unique()) == {2023, 2024}
    assert set(df["country"].unique()) == {"fr", "de"}
    assert len(df[df["year"] == 2023]) == 10


def test_partition_filter_prunes_before_read(ray_cluster, tmp_path):
    base = str(tmp_path / "tree")
    _write_hive_tree(base)
    part = Partitioning("hive", base_dir=base)
    ds = rd.read_parquet(
        base, partitioning=part,
        partition_filter=lambda f: f["year"] == "2024" and f["country"] == "fr",
    )
    df = ds.to_pandas()
    assert len(df) == 3
    assert set(df["country"].unique()) == {"fr"}
    with pytest.raises(ValueError):
        rd.read_parquet(base, partitioning=part, partition_filter=lambda f: False)


def test_dir_partitioning(ray_cluster, tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    base = str(tmp_path / "dirtree")
    for split in ("train", "test"):
        d = os.path.join(base, split, "v1")
        os.makedirs(d)
        pq.write_table(pa.table({"x": [1, 2]}), os.path.join(d, "f.parquet"))
    part = Partitioning("dir", base_dir=base, field_names=["split", "version"])
    df = rd.read_parquet(base, partitioning=part).to_pandas()
    assert set(df["split"].unique()) == {"train", "test"}
    assert set(df["version"].unique()) == {"v1"}


def test_parquet_metadata_provider_exact_rows(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    from ray_tpu_torch.data import DefaultFileMetadataProvider, ParquetMetadataProvider

    f = str(tmp_path / "f.parquet")
    pq.write_table(pa.table({"x": list(range(42))}), f)
    meta = ParquetMetadataProvider().get_metadata([f])
    assert meta.num_rows == 42
    assert meta.size_bytes > 0
    d = DefaultFileMetadataProvider().get_metadata([f])
    assert d.num_rows == -1 and d.size_bytes == os.path.getsize(f)


def test_webdataset_roundtrip(ray_cluster, tmp_path):
    out = str(tmp_path / "shards")
    items = [
        {"__key__": f"sample{i:04d}", "txt": f"hello {i}", "cls": i % 3, "meta": {"idx": i}}
        for i in range(20)
    ]
    ds = rd.from_items(items, parallelism=2)
    files = ds.write_webdataset(out)
    assert files and all(f.endswith(".tar") for f in files)
    back = rd.read_webdataset(out).to_pandas().sort_values("__key__").reset_index(drop=True)
    assert len(back) == 20
    assert back.loc[5, "txt"] == "hello 5"
    assert int(back.loc[5, "cls"]) == 5 % 3
    assert back.loc[5, "meta"]["idx"] == 5


def test_mongo_datasource_partitions_with_injected_client(ray_cluster):
    docs = [{"_id": i, "v": i * i} for i in range(30)]

    class FakeCollection:
        def count_documents(self, q):
            return len(docs)

        def aggregate(self, stages):
            out = list(docs)
            for st in stages:
                if "$sort" in st:
                    for key, direction in reversed(list(st["$sort"].items())):
                        out = sorted(out, key=lambda d: d[key], reverse=direction < 0)
                elif "$skip" in st:
                    out = out[st["$skip"]:]
                elif "$limit" in st:
                    out = out[: st["$limit"]]
                elif "$match" in st:
                    kv = st["$match"]
                    out = [d for d in out if all(d.get(k) == v for k, v in kv.items())]
            return iter(out)

    ds = rd.read_mongo("mongodb://unused", "db", "coll", collection_factory=FakeCollection, parallelism=4)
    df = ds.to_pandas()
    assert len(df) == 30
    assert sorted(df["v"]) == [i * i for i in range(30)]
    assert "_id" not in df.columns


def test_mongo_requires_pymongo_without_factory(ray_cluster):
    with pytest.raises(ImportError):
        rd.read_mongo("mongodb://x", "db", "coll")


# ---------------------------------------------------------------------------
# tests/test_preprocessors.py's cases
# ---------------------------------------------------------------------------


def _ds(rows):
    return rd.from_items(rows)


def test_standard_scaler(ray_cluster):
    ds = _ds([{"a": 1.0}, {"a": 2.0}, {"a": 3.0}])
    s = StandardScaler(["a"])
    out = s.fit_transform(ds).take_all()
    vals = [r["a"] for r in out]
    assert abs(np.mean(vals)) < 1e-9
    b = s.transform_batch({"a": np.array([2.0])})
    assert abs(b["a"][0]) < 1e-9


def test_min_max_scaler(ray_cluster):
    ds = _ds([{"x": 0.0}, {"x": 5.0}, {"x": 10.0}])
    out = MinMaxScaler(["x"]).fit_transform(ds).take_all()
    assert [r["x"] for r in out] == [0.0, 0.5, 1.0]


def test_label_and_onehot_encoders(ray_cluster):
    ds = _ds([{"c": "red", "y": "no"}, {"c": "blue", "y": "yes"}, {"c": "red", "y": "yes"}])
    le = LabelEncoder("y").fit(ds)
    assert le.classes_ == ["no", "yes"]
    assert [r["y"] for r in le.transform(ds).take_all()] == [0, 1, 1]
    oh = OneHotEncoder(["c"]).fit(ds)
    rows = oh.transform(ds).take_all()
    assert rows[0]["c_red"] == 1 and rows[0]["c_blue"] == 0
    assert "c" not in rows[0]


def test_imputer(ray_cluster):
    ds = _ds([{"v": 1.0}, {"v": float("nan")}, {"v": 3.0}])
    rows = SimpleImputer(["v"]).fit_transform(ds).take_all()
    assert [r["v"] for r in rows] == [1.0, 2.0, 3.0]


def test_concatenator_and_batch_mapper(ray_cluster):
    ds = _ds([{"a": 1.0, "b": 2.0}, {"a": 3.0, "b": 4.0}])
    rows = Concatenator(columns=["a", "b"], output_column_name="feat").transform(ds).take_all()
    assert np.allclose(rows[0]["feat"], [1.0, 2.0])
    doubled = BatchMapper(lambda b: {"a": np.asarray(b["a"]) * 2, "b": b["b"]}).transform(ds)
    assert [r["a"] for r in doubled.take_all()] == [2.0, 6.0]


def test_chain_and_not_fitted(ray_cluster):
    ds = _ds([{"a": 1.0, "b": 10.0}, {"a": 3.0, "b": 30.0}])
    chain = Chain(StandardScaler(["a"]), MinMaxScaler(["b"]))
    with pytest.raises(PreprocessorNotFittedError):
        chain.transform(ds)
    rows = chain.fit_transform(ds).take_all()
    assert rows[0]["b"] == 0.0 and rows[1]["b"] == 1.0


def test_torch_predictor_and_batch_predictor(ray_cluster):
    """test_jax_predictor_and_batch_predictor on TorchPredictor: the same
    model (y = x @ w), checkpoint and assertions, on the CPU."""
    import torch

    params = {"w": np.array([[2.0], [3.0]], dtype=np.float32)}

    def apply_fn(params, x):
        return x @ params["w"]

    ckpt = Checkpoint.from_dict({"params": params, "apply_fn": apply_fn})
    pred = TorchPredictor.from_checkpoint(ckpt, input_column="feat", device="cpu")
    assert isinstance(pred.params["w"], torch.Tensor)
    out = pred.predict({"feat": np.array([[1.0, 1.0]], dtype=np.float32)})
    assert np.allclose(out["predictions"], [[5.0]])

    ds = rd.from_items([{"a": float(i), "b": float(i)} for i in range(8)])
    ds = Concatenator(columns=["a", "b"], output_column_name="feat", dtype=np.float32).transform(ds)
    bp = BatchPredictor.from_checkpoint(ckpt, TorchPredictor, input_column="feat", device="cpu")
    scored = bp.predict(ds, batch_size=4, max_scoring_workers=2)
    preds = [float(np.ravel(r["predictions"])[0]) for r in scored.take_all()]
    assert preds == [5.0 * i for i in range(8)]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TorchPredictor.from_checkpoint(ckpt, input_column="feat")


def test_extended_scalers_and_discretizers(ray_cluster):
    from ray_tpu_torch.data.preprocessors import (
        CustomKBinsDiscretizer,
        MaxAbsScaler,
        RobustScaler,
        UniformKBinsDiscretizer,
    )

    rows = [{"x": float(i)} for i in range(100)]
    ds = _ds(rows)
    out = MaxAbsScaler(["x"]).fit_transform(ds).to_pandas()
    assert abs(out["x"].max() - 1.0) < 1e-9

    out = RobustScaler(["x"]).fit_transform(ds).to_pandas()
    assert abs(np.median(out["x"])) < 0.1
    assert 0.8 < (np.quantile(out["x"], 0.75) - np.quantile(out["x"], 0.25)) < 1.2

    out = UniformKBinsDiscretizer(["x"], bins=4).fit_transform(ds).to_pandas()
    assert set(out["x"].unique()) == {0, 1, 2, 3}
    assert out["x"].iloc[0] == 0 and out["x"].iloc[99] == 3

    out = CustomKBinsDiscretizer(["x"], bin_edges=[25.0, 50.0]).transform(ds).to_pandas()
    assert set(out["x"].unique()) == {0, 1, 2}


def test_normalizer_and_power_transform(ray_cluster):
    from ray_tpu_torch.data.preprocessors import Normalizer, PowerTransformer

    ds = _ds([{"a": 3.0, "b": 4.0}, {"a": 0.0, "b": 0.0}])
    out = Normalizer(["a", "b"], norm="l2").transform(ds).to_pandas()
    assert abs(out.loc[0, "a"] - 0.6) < 1e-9 and abs(out.loc[0, "b"] - 0.8) < 1e-9
    assert out.loc[1, "a"] == 0.0

    ds = _ds([{"x": 3.0}])
    out = PowerTransformer(["x"], power=0.0, method="box-cox").transform(ds).to_pandas()
    assert abs(out.loc[0, "x"] - np.log(3.0)) < 1e-9
    out = PowerTransformer(["x"], power=1.0, method="yeo-johnson").transform(ds).to_pandas()
    assert abs(out.loc[0, "x"] - 3.0) < 1e-9


def test_ordinal_and_multihot_encoders(ray_cluster):
    from ray_tpu_torch.data.preprocessors import MultiHotEncoder, OrdinalEncoder
    from ray_tpu_torch.exceptions import TaskError

    ds = _ds([{"c": "red"}, {"c": "blue"}, {"c": "red"}])
    enc = OrdinalEncoder(["c"])
    out = enc.fit_transform(ds).to_pandas()
    assert list(out["c"]) == [1, 0, 1]
    with pytest.raises((ValueError, TaskError), match="unseen value"):
        enc.transform(_ds([{"c": "green"}])).to_pandas()

    ds = _ds([{"tags": ["a", "b"]}, {"tags": ["b"]}, {"tags": []}])
    out = MultiHotEncoder(["tags"]).fit_transform(ds).to_pandas()
    mat = np.stack(out["tags"].to_numpy())
    np.testing.assert_array_equal(mat, [[1, 1], [0, 1], [0, 0]])


def test_tokenizer_and_vectorizers(ray_cluster):
    from ray_tpu_torch.data.preprocessors import (
        CountVectorizer,
        FeatureHasher,
        HashingVectorizer,
        Tokenizer,
    )

    ds = _ds([{"t": "The cat and the hat"}, {"t": "a cat"}])
    out = Tokenizer(["t"]).transform(ds).to_pandas()
    assert list(out["t"].iloc[0]) == ["the", "cat", "and", "the", "hat"]

    out = CountVectorizer(["t"], max_features=3).fit_transform(ds).to_pandas()
    assert out["t_cat"].tolist() == [1, 1]
    assert out["t_the"].tolist() == [2, 0]
    assert "t" not in out.columns

    out = HashingVectorizer(["t"], num_features=8).transform(ds).to_pandas()
    hashed_cols = [c for c in out.columns if c.startswith("t_hash_")]
    assert len(hashed_cols) == 8
    assert out[hashed_cols].to_numpy().sum() == 7

    ds = _ds([{"u": "x", "v": 1}, {"u": "y", "v": 1}])
    out = FeatureHasher(["u", "v"], num_features=16).transform(ds).to_pandas()
    mat = np.stack(out["hashed_features"].to_numpy())
    assert mat.shape == (2, 16) and mat.sum() == 4
    assert (mat[0] != mat[1]).any()


# ---------------------------------------------------------------------------
# Against the reference, and without pyarrow or pandas
# ---------------------------------------------------------------------------


def _preprocessed(pkg, pre):
    rng = np.random.default_rng(4)
    rows = [{"a": float(rng.standard_normal()), "b": float(rng.uniform(0, 9)), "c": ["x", "y", "z"][i % 3],
             "t": " ".join(rng.choice(["red", "cat", "hat", "sun"], 3))} for i in range(60)]
    chain = pre.Chain(pre.StandardScaler(["a"]), pre.RobustScaler(["b"]), pre.OrdinalEncoder(["c"]),
                      pre.CountVectorizer(["t"], max_features=3), pre.Concatenator(exclude=["c"], output_column_name="f"))
    return chain.fit_transform(pkg.from_items(rows, parallelism=3)).take_all()


def test_fitted_preprocessors_match_reference(ray_cluster):
    """Scalers, a reservoir-fitted RobustScaler, an encoder, a vectorizer and
    the concatenation, fitted on the same seeded rows: the reference's rows."""
    import ray_tpu
    import ray_tpu.data as jd
    import ray_tpu.data.preprocessors as jpre
    import ray_tpu_torch.data.preprocessors as tpre

    ray_tpu.init(num_cpus=4, object_store_memory=128 * 1024 * 1024)
    try:
        want = _preprocessed(jd, jpre)
    finally:
        ray_tpu.shutdown()
    got = _preprocessed(rd, tpre)
    assert len(got) == len(want) == 60
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        np.testing.assert_array_equal(g["f"], w["f"])
        assert g["c"] == w["c"]


def test_pyarrow_and_pandas_calls_raise_without_them(ray_cluster, tmp_path, monkeypatch):
    """With pyarrow and then pandas hidden, each call that needs one raises
    ImportError naming the package and the call; numpy batches still flow."""
    ds = rd.range(10, parallelism=2)
    for name in ("pyarrow", "pyarrow.parquet"):
        monkeypatch.setitem(sys.modules, name, None)
    calls = {
        "read_parquet": lambda: rd.read_parquet(str(tmp_path)),
        "write_parquet": lambda: ds.write_parquet(str(tmp_path / "out")),
        "to_arrow_refs": ds.to_arrow_refs,
        "from_arrow": lambda: rd.from_arrow([]),
        'batch_format="pyarrow"': lambda: next(iter(ds.iter_batches(batch_format="pyarrow"))),
        "ParquetMetadataProvider": lambda: rd.ParquetMetadataProvider().get_metadata([]),
    }
    for call, fn in calls.items():
        with pytest.raises(ImportError, match=f"{call}.*'pyarrow'"):
            fn()
    monkeypatch.undo()
    monkeypatch.setitem(sys.modules, "pandas", None)
    calls = {
        "Dataset.to_pandas": ds.to_pandas,
        "from_pandas": lambda: rd.from_pandas([]),
        'batch_format="pandas"': lambda: next(iter(ds.iter_batches(batch_format="pandas"))),
    }
    for call, fn in calls.items():
        with pytest.raises(ImportError, match=f"{call}.*'pandas'"):
            fn()
    assert [b["id"].tolist() for b in ds.iter_batches(batch_size=5)] == [[0, 1, 2, 3, 4], [5, 6, 7, 8, 9]]
