"""The port's durable datasets (``sheeprl_tpu_torch/data/datasets.py``) held
to the JAX package's (``sheeprl_tpu/data/datasets.py``) on the CPU: a
dataset either package writes opens in the other with the same arrays and
manifests; ``OfflineDataset.batches`` yields the JAX loader's batches for
the same seed, element for element (flat and sequence windows, with and
without episode boundaries, prefetch 0 and 2); torn, truncated and corrupt
shards are skipped with the JAX reasons.  Both are numpy, so every check is
exact.  The manifests differ only in ``sha256`` (``np.savez`` stamps a time
into the zip), ``fingerprint`` (the writing package) and ``written_t``."""

from __future__ import annotations

import json
import os
from itertools import islice

import numpy as np
import pytest

from sheeprl_tpu.data import datasets as jax_datasets
from sheeprl_tpu_torch.data import datasets
from test_torch_threads import one_torch_thread  # noqa: F401  (one torch thread a worker)

STAMPED = ("sha256", "fingerprint", "written_t")


def _stream(rng, rows: int, first_at=(), with_rssm: bool = False):
    out = {
        "rgb": rng.integers(0, 256, (rows, 3, 4, 4), dtype=np.uint8),
        "state": rng.normal(size=(rows, 5)).astype(np.float32),
        "actions": rng.normal(size=(rows, 2)).astype(np.float32),
        "rewards": rng.normal(size=(rows, 1)).astype(np.float32),
        "terminated": np.zeros((rows, 1), np.float32),
        "truncated": np.zeros((rows, 1), np.float32),
        "is_first": np.zeros((rows, 1), np.float32),
    }
    for t in first_at:
        out["is_first"][t] = 1
        if t > 0:
            out["terminated"][t - 1] = 1
    if with_rssm:
        out["rssm_recurrent"] = rng.normal(size=(rows, 6)).astype(np.float32)
        out["rssm_valid"] = (rng.random((rows, 1)) > 0.1).astype(np.float32)
    return out


def _write(package, root, streams, shard_rows: int = 7):
    """Every stream of ``streams`` into ``root`` with ``package``'s
    ``write_shard``, ``shard_rows`` rows a shard; the logical steps start at
    ``10 * stream``."""
    package.write_dataset_meta(str(root), {"algo": "test", "seed": 3})
    for stream, arrays in streams.items():
        rows = len(next(iter(arrays.values())))
        for off in range(0, rows, shard_rows):
            package.write_shard(str(root), stream, 10 * stream + off,
                                {k: v[off:off + shard_rows] for k, v in arrays.items()})


@pytest.fixture(scope="module")
def streams():
    rng = np.random.default_rng(0)
    return {0: _stream(rng, 30, first_at=(0, 9, 21), with_rssm=True),
            1: _stream(rng, 17, first_at=(0, 5), with_rssm=True), 3: _stream(rng, 24, first_at=(0, 12), with_rssm=True)}


@pytest.mark.parametrize("writer, reader", [(jax_datasets, datasets), (datasets, jax_datasets)],
                         ids=["jax_written_port_reads", "port_written_jax_reads"])
def test_a_dataset_either_package_writes_opens_in_the_other(tmp_path, streams, writer, reader):
    """The same streams written by each package: the other opens them with
    the arrays bit-identical, the same segments and summary, and every
    manifest field equal but the stamped ones."""
    ours, theirs = tmp_path / "written", tmp_path / "reference"
    _write(writer, ours, streams)
    _write(reader, theirs, streams)
    opened, reference = reader.OfflineDataset(str(ours)), reader.OfflineDataset(str(theirs))
    assert not opened.skipped and opened.keys == reference.keys and opened.streams == (0, 1, 3)
    assert {k: v for k, v in opened.summary().items() if k != "path"} == \
        {k: v for k, v in reference.summary().items() if k != "path"}
    for seg in reference.segments:
        got = opened.gather_window(seg.stream, seg.start, seg.rows)
        want = streams[seg.stream]
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for name in sorted(os.listdir(theirs)):
        if name.endswith(datasets.SHARD_MANIFEST_SUFFIX):
            a, b = (json.loads((root / name).read_text()) for root in (ours, theirs))
            assert sorted(a) == sorted(b)
            assert {k: v for k, v in a.items() if k not in STAMPED} == {k: v for k, v in b.items() if k not in STAMPED}
    meta_a, meta_b = writer.read_dataset_meta(str(ours)), reader.read_dataset_meta(str(theirs))
    assert meta_a["format"] == meta_b["format"] == 1 and meta_a["meta"] == meta_b["meta"]
    # merge-updating the meta keeps what was there, as the JAX writer does
    for package, root in ((writer, ours), (reader, theirs)):
        package.write_dataset_meta(str(root), {"env_id": "x", "seed": None})
    assert writer.read_dataset_meta(str(ours))["meta"] == reader.read_dataset_meta(str(theirs))["meta"] == \
        {"algo": "test", "seed": 3, "env_id": "x"}


def _both(root):
    return datasets.OfflineDataset(str(root)), jax_datasets.OfflineDataset(str(root))


def _same_batches(ours, theirs, n: int):
    for i, (a, b) in enumerate(zip(islice(ours, n), islice(theirs, n))):
        assert sorted(a) == sorted(b), i
        for k in b:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, (i, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"batch {i} key {k}")


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("derive_next", [False, True])
def test_flat_batches_are_the_jax_loaders(tmp_path, streams, prefetch, derive_next):
    """Flat batches over several epochs (the shuffle window smaller than the
    dataset), with the successor rows derived or not: the JAX loader's, with
    the same epoch callbacks, prefetch on or off on either side."""
    _write(datasets, tmp_path, streams)
    ours, theirs = _both(tmp_path)
    epochs = {"port": [], "jax": []}
    kwargs = dict(seed=5, mode="flat", derive_next_obs=derive_next, next_obs_keys=("state", "rgb"), shuffle_window=16)
    got = ours.batches(9, prefetch=prefetch, on_epoch=epochs["port"].append, **kwargs)
    want = theirs.batches(9, prefetch=2 - prefetch, on_epoch=epochs["jax"].append, **kwargs)
    _same_batches(got, want, 20)
    assert epochs["port"][:3] == [0, 1, 2] and epochs["jax"][:3] == [0, 1, 2]


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("respect_episodes", [False, True])
def test_sequence_windows_are_the_jax_loaders(tmp_path, streams, prefetch, respect_episodes):
    """``[T, B, ...]`` windows with the stored states, inside one segment
    and, with ``respect_episodes``, one episode (``is_first``); a shard
    skipped in the middle of stream 0 splits it into two segments, which no
    window crosses."""
    _write(datasets, tmp_path, streams)
    os.remove(tmp_path / (datasets.shard_name(0, 7) + datasets.SHARD_MANIFEST_SUFFIX))
    ours, theirs = _both(tmp_path)
    assert [s.rows for s in ours.segments] == [s.rows for s in theirs.segments] == [7, 16, 17, 24]
    kwargs = dict(seed=11, mode="sequence", sequence_length=5, respect_episodes=respect_episodes,
                  keys=("rgb", "actions", "is_first", "terminated", "rssm_recurrent", "rssm_valid"), shuffle_window=8)
    got = list(islice(ours.batches(4, prefetch=prefetch, **kwargs), 12))
    _same_batches(iter(got), theirs.batches(4, prefetch=prefetch, **kwargs), 12)
    assert got[0]["rgb"].shape == (5, 4, 3, 4, 4)
    if respect_episodes:
        # no window holds a first step after its first row
        assert all(not b["is_first"][1:].any() for b in got)


def test_episode_boundaries_without_is_first_come_from_the_done_flags(tmp_path, streams):
    """A dataset without ``is_first`` (an older export): the boundaries
    follow the done rows, as the JAX loader derives them."""
    trimmed = {k: {kk: vv for kk, vv in v.items() if kk != "is_first"} for k, v in streams.items()}
    _write(datasets, tmp_path, trimmed)
    ours, theirs = _both(tmp_path)
    for seg_ours, seg_theirs in zip(ours.segments, theirs.segments):
        np.testing.assert_array_equal(ours._episode_boundaries(seg_ours), theirs._episode_boundaries(seg_theirs))
    kwargs = dict(seed=2, mode="sequence", sequence_length=4, respect_episodes=True, shuffle_window=1 << 16)
    _same_batches(ours.batches(3, **kwargs), theirs.batches(3, **kwargs), 10)


def test_gather_reads_arbitrary_steps_as_the_jax_dataset_does(tmp_path, streams):
    _write(jax_datasets, tmp_path, streams)
    ours, theirs = _both(tmp_path)
    steps = [12, 0, 29, 7, 7, 20]
    a, b = ours.gather(0, steps), theirs.gather(0, steps)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with pytest.raises(IndexError, match="not covered"):
        ours.gather(1, [100])
    with pytest.raises(IndexError, match="crosses the end"):
        ours.gather_window(1, 20, 9)
    with pytest.raises(ValueError, match="usable transitions"):
        next(ours.batches(1000, seed=0))
    with pytest.raises(ValueError, match="mode must be"):
        ours.batches(2, seed=0, mode="episodes")


def _corrupt(root, kind: str) -> str:
    path = os.path.join(root, datasets.shard_name(1, 17))
    if kind == "no_manifest":
        os.remove(path + datasets.SHARD_MANIFEST_SUFFIX)
    elif kind == "size_mismatch":
        with open(path, "r+b") as fp:
            fp.truncate(os.path.getsize(path) - 11)
    elif kind == "digest_mismatch":
        with open(path, "r+b") as fp:
            fp.seek(40)
            fp.write(b"\xde\xad\xbe\xef")
    elif kind == "empty":
        open(path, "wb").close()
    return path


@pytest.mark.parametrize("kind", ["no_manifest", "size_mismatch", "digest_mismatch", "empty"])
def test_torn_truncated_and_corrupt_shards_are_skipped_with_the_jax_reasons(tmp_path, streams, kind):
    _write(datasets, tmp_path, streams)
    bad = _corrupt(str(tmp_path), kind)
    assert datasets.verify_shard(bad) == jax_datasets.verify_shard(bad) == (False, kind)
    good, skipped = datasets.discover_shards(str(tmp_path))
    jax_good, jax_skipped = jax_datasets.discover_shards(str(tmp_path))
    assert skipped == jax_skipped == [{"path": bad, "reason": kind}]
    assert [(e["stream"], e["start"], e["stop"]) for e in good] == [(e["stream"], e["start"], e["stop"]) for e in jax_good]
    ours, theirs = _both(tmp_path)
    assert ours.summary() == theirs.summary() and ours.summary()["skipped"] == 1
    # a shallow check passes a flipped byte; the deep one catches it
    if kind == "digest_mismatch":
        assert datasets.verify_shard(bad, deep=False) == (True, "verified")


def test_an_empty_or_missing_dataset_raises_and_a_bad_shard_write_is_refused(tmp_path):
    with pytest.raises(FileNotFoundError, match="No verifiable dataset shards"):
        datasets.OfflineDataset(str(tmp_path / "none"))
    with pytest.raises(ValueError, match="empty shard"):
        datasets.write_shard(str(tmp_path), 0, 0, {})
    with pytest.raises(ValueError, match="time axis"):
        datasets.write_shard(str(tmp_path), 0, 0, {"a": np.zeros(3), "b": np.zeros(4)})
    with pytest.raises(ValueError, match="zero-row"):
        datasets.write_shard(str(tmp_path), 0, 0, {"a": np.zeros((0, 2))})
    assert datasets.shard_name(3, 42) == jax_datasets.shard_name(3, 42) == "shard-00003-0000000042.npz"


def test_the_prefetch_thread_surfaces_a_loader_error_and_stops_with_its_consumer():
    def failing():
        yield {"a": np.zeros(1)}
        raise RuntimeError("shard vanished")

    it = datasets._prefetch_iter(failing(), depth=2)
    assert next(it)["a"].shape == (1,)
    with pytest.raises(RuntimeError, match="shard vanished"):
        next(it)
    endless = datasets._prefetch_iter(({"i": np.asarray(i)} for i in range(10**9)), depth=1)
    assert [int(next(endless)["i"]) for _ in range(3)] == [0, 1, 2]
    endless.close()  # the consumer's exit stops the producer thread
