"""The port's record and stream formats against the JAX package, on the CPU.

- ``.bdlrec`` files written by either package are byte-identical and each
  package reads the other's, in JAX's shuffled order; a corrupt record and
  a truncated file raise ``RecordIOError``;
- ``to_bdlrec`` turns one access-log directory into shards byte-identical
  to JAX's;
- the decoded-sample cache: the files built by either package are
  byte-identical and each serves the other's warm epoch (decode absent); a
  corrupt data file is quarantined as JAX quarantines it; the
  ``cache_read`` and ``cache_write`` fault sites fire;
- ``StreamingDataSet``: the record order of ``.bdlrec`` and ``.tar``
  shards equals JAX's for a seed and a window, over two epochs;
  ``position_after``/``data_from`` seek exactly;
- a streamed trainer preempted mid-epoch and resumed from its checkpoint
  replays the uninterrupted run bit for bit (the checkpoint's ``stream``
  key, which JAX's loader reads as JAX wrote it);
- the image decoder as the record sources' default, and the refusals: ``distributed=True``
  and ``shard()`` (A.6).
"""

import io
import json
import os
import tarfile

import numpy as np
import pytest
import torch

from bigdl_tpu.dataset import recordio as jrec
from bigdl_tpu.dataset import sample_cache as jcache
from bigdl_tpu.dataset import streaming as jstream
from bigdl_tpu.dataset.sample import Sample as JSample
from bigdl_tpu.obs import access_log as jaccess
from bigdl_tpu.utils import faults as jfaults
from bigdl_tpu.utils import file as jfile
from bigdl_tpu.utils.random_generator import RandomGenerator as JaxRNG
from bigdl_tpu.utils.robustness import events as jevents
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset import (
    DataSet, Sample, SampleToMiniBatch, recordio, sample_cache, streaming,
)
from bigdl_tpu_torch.dataset.profiling import STAGE_CACHE, STAGE_DECODE
from bigdl_tpu_torch.dataset.profiling import feed_stats
from bigdl_tpu_torch.obs import access_log
from bigdl_tpu_torch.optim import SGD, LocalOptimizer, Trigger
from bigdl_tpu_torch.optim.optimizer import TrainingPreempted
from bigdl_tpu_torch.utils import faults
from bigdl_tpu_torch.utils.random_generator import RandomGenerator
from bigdl_tpu_torch.utils.robustness import events


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _payload(i: int) -> bytes:
    """Record i: a float32 feature of 3 values and an int32 label."""
    x = (np.arange(3, dtype=np.float32) + 10 * i).tobytes()
    return np.int32(i % 5).tobytes() + x


def _decoder(sample_cls):
    """A decoder of :func:`_payload` records, named the same in both
    packages (the cache's key includes the decoder's name)."""
    def call(self, payload):
        label = np.frombuffer(payload[:4], np.int32)[0]
        return sample_cls(np.frombuffer(payload[4:], np.float32).copy(),
                          np.int32(label))
    return type("PayloadDecoder", (), {"__call__": call})()


def _shards(root, n_shards=4, per=6, writer=jrec.write_records):
    os.makedirs(root, exist_ok=True)
    paths = []
    for s in range(n_shards):
        p = os.path.join(root, f"part-{s:02d}.bdlrec")
        writer(p, [_payload(s * per + i) for i in range(per)])
        paths.append(p)
    return paths


def _ids(records) -> list:
    return [int(r.feature[0][0]) // 10 for r in records]


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def test_bdlrec_files_byte_identical_and_read_across(tmp_path):
    jp = _shards(tmp_path / "jax", writer=jrec.write_records)
    tp = _shards(tmp_path / "port", writer=recordio.write_records)
    assert [_read(a) for a in jp] == [_read(b) for b in tp]
    with recordio.RecordWriter(str(tmp_path / "w.bdlrec")) as w:
        w.write(b"x")
        assert w.count == 1
    for seed in (3, 4):
        JaxRNG.set_seed(seed)
        RandomGenerator.set_seed(seed)
        jds = jrec.RecordFileDataSet(tp, _decoder(JSample), num_workers=2)
        tds = DataSet.record_files(jp, _decoder(Sample), num_workers=2)
        jds.shuffle()
        tds.shuffle()
        assert _ids(tds.data(True)) == _ids(jds.data(True))
        assert tds.size() == jds.size() == 24
        tds.close()
        jds.close()


def test_corrupt_and_truncated_records_raise(tmp_path):
    (p,) = _shards(tmp_path, n_shards=1, per=3)
    raw = bytearray(_read(p))
    raw[-2] ^= 0xFF
    bad = str(tmp_path / "bad.bdlrec")
    with open(bad, "wb") as f:
        f.write(bytes(raw))
    for mod, dec, err in ((recordio, _decoder(Sample), recordio.RecordIOError),
                          (jrec, _decoder(JSample), jrec.RecordIOError)):
        ds = mod.RecordFileDataSet(bad, dec, num_workers=1)
        with pytest.raises(err, match="crc mismatch"):
            list(ds.data(True))
        ds.close()
    short = str(tmp_path / "short.bdlrec")
    with open(short, "wb") as f:
        f.write(bytes(raw[:-5]))
    with pytest.raises(recordio.RecordIOError, match="truncated payload"):
        recordio.RecordFileDataSet(short, _decoder(Sample))
    with open(short, "wb") as f:
        f.write(b"NOPE" + bytes(4))
    with pytest.raises(recordio.RecordIOError, match="not a .bdlrec"):
        recordio.RecordFileDataSet(short, _decoder(Sample))


def test_to_bdlrec_byte_identical_to_jax(tmp_path):
    logs = tmp_path / "logs"
    logs.mkdir()
    for gen in range(2):
        with open(logs / f"access-{gen}.jsonl", "w") as f:
            for i in range(5):
                f.write(json.dumps({"trace_id": f"{gen}-{i}", "outcome": "ok",
                                    "e2e_ms": 1.5 * i}) + "\n")
            f.write("\n" if gen else '{"torn": ')
    tp, tn = access_log.to_bdlrec(str(logs), str(tmp_path / "port"), shards=3)
    jp, jn = jaccess.to_bdlrec(str(logs), str(tmp_path / "jax"), shards=3)
    assert tn == jn == 10
    assert [os.path.basename(p) for p in tp] == [os.path.basename(p)
                                                 for p in jp]
    assert [_read(a) for a in tp] == [_read(b) for b in jp]
    ds = streaming.StreamingDataSet(tp, decoder=access_log.access_record_decoder,
                                    shuffle_window=0)
    assert sorted(r["trace_id"] for r in ds.data(True)) == sorted(
        f"{g}-{i}" for g in range(2) for i in range(5))


def _stream(mod, paths, sample_cls, window=4, **kw):
    return mod.StreamingDataSet(paths, decoder=_decoder(sample_cls),
                                shuffle_window=window, num_workers=2, **kw)


def _epoch(ds):
    ds.shuffle()
    return _ids(ds.data(True))


def test_stream_order_equals_jax(tmp_path):
    paths = _shards(tmp_path, n_shards=4, per=7)
    tar = str(tmp_path / "part-04.tar")
    with tarfile.open(tar, "w") as tf:
        for i in range(5):
            data = _payload(28 + i)
            info = tarfile.TarInfo(f"{i:04d}.rec")
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
    paths.append(tar)
    for window in (0, 4, 64):
        JaxRNG.set_seed(11)
        RandomGenerator.set_seed(11)
        j = _stream(jstream, paths, JSample, window)
        t = _stream(streaming, paths, Sample, window)
        for _ in range(2):
            want = _epoch(j)
            assert _epoch(t) == want
            assert sorted(want) == list(range(33))
        assert t.stream_state() == j.stream_state()
        pos = t.position_after(9)
        assert pos == j.position_after(9)
        assert _ids(t.data_from(pos)) == want[9:]
        t.close()
        j.close()


def _cache_epochs(mod, paths, sample_cls, cache_dir, n=2):
    """Records of ``n`` epochs with the cache on, and each epoch's decode
    count."""
    ds = _stream(mod, paths, sample_cls, cache=True, cache_dir=cache_dir)
    out = []
    for _ in range(n):
        before = feed_stats.snapshot()[STAGE_DECODE][1] \
            if mod is streaming else None
        recs = _epoch(ds)
        decoded = (feed_stats.snapshot()[STAGE_DECODE][1] - before
                   if mod is streaming else None)
        out.append((recs, decoded))
    ds.close()
    return out


def _cache_files(d) -> dict:
    return {n: _read(os.path.join(d, n)) for n in sorted(os.listdir(d))}


def test_cache_files_byte_identical_and_served_across(tmp_path):
    paths = _shards(tmp_path / "shards")
    JaxRNG.set_seed(5)
    RandomGenerator.set_seed(5)
    jout = _cache_epochs(jstream, paths, JSample, str(tmp_path / "jc"))
    tout = _cache_epochs(streaming, paths, Sample, str(tmp_path / "tc"))
    assert [r for r, _ in tout] == [r for r, _ in jout]
    assert tout[0][1] == 24 and tout[1][1] == 0      # epoch 2 decodes none
    jfiles, tfiles = (_cache_files(tmp_path / "jc"),
                      _cache_files(tmp_path / "tc"))
    assert list(tfiles) == list(jfiles) and len(tfiles) == 2
    assert tfiles == jfiles
    # the port serves JAX's cache warm, and JAX the port's
    RandomGenerator.set_seed(5)
    JaxRNG.set_seed(5)
    warm = _cache_epochs(streaming, paths, Sample, str(tmp_path / "jc"), n=1)
    assert warm[0][1] == 0 and warm[0][0] == tout[0][0]
    jwarm = _stream(jstream, paths, JSample, cache=True,
                    cache_dir=str(tmp_path / "tc"))
    assert jwarm._cache_obj().try_open()
    jwarm.close()
    key = os.path.splitext(next(iter(tfiles)))[0]
    rec = sample_cache.SampleCache(str(tmp_path / "jc"), key, 24)
    assert rec.try_open()
    s = rec.read(3)
    assert isinstance(s, Sample) and int(s.label[0]) == 3
    with pytest.raises(sample_cache.CacheCorruptError, match="missing"):
        rec.read(99)


def test_corrupt_cache_quarantined_as_jax(tmp_path):
    paths = _shards(tmp_path / "shards", n_shards=2, per=4)
    RandomGenerator.set_seed(2)
    _cache_epochs(streaming, paths, Sample, str(tmp_path / "c"), n=1)
    data = [n for n in os.listdir(tmp_path / "c") if n.endswith(".data")][0]
    with open(tmp_path / "c" / data, "r+b") as f:
        f.seek(5)
        b = f.read(1)
        f.seek(5)
        f.write(bytes([b[0] ^ 0xFF]))
    snap = events.snapshot()
    out = _cache_epochs(streaming, paths, Sample, str(tmp_path / "c"), n=1)
    assert out[0][1] == 8                      # decoded live
    assert events.deltas(snap).get("cache_fallback") == 1
    names = sorted(os.listdir(tmp_path / "c"))
    assert any(n.endswith(".data.corrupt") for n in names)
    assert any(n.endswith(".idx.corrupt") for n in names)
    key = data[:-len(".data")]
    for mod in (sample_cache, jcache):
        c = mod.SampleCache(str(tmp_path / "c"), key, 8)
        assert not c.try_open()              # quarantined: no pair left


@pytest.mark.parametrize("site", ["cache_read", "cache_write"])
def test_cache_fault_sites_fire(tmp_path, site):
    paths = _shards(tmp_path / "shards", n_shards=2, per=4)
    RandomGenerator.set_seed(2)
    cdir = str(tmp_path / "c")
    if site == "cache_read":
        _cache_epochs(streaming, paths, Sample, cdir, n=1)
    snap = events.snapshot()
    with faults.inject_faults(f"{site}@2"):
        (recs, decoded), = _cache_epochs(streaming, paths, Sample, cdir, n=1)
    assert sorted(recs) == list(range(8))
    deltas = events.deltas(snap)
    assert deltas.get("fault_injected") == 1
    if site == "cache_read":
        assert decoded == 7 and deltas.get("cache_fallback") == 1
    else:
        assert decoded == 8 and deltas.get("cache_write_failed") == 1
        assert not any(n.endswith(".data") for n in os.listdir(cdir))
    with pytest.raises(ValueError):
        faults.parse_plan("obs_spool_write@1")
    assert jfaults._DEFAULT_ACTION[site] == faults._DEFAULT_ACTION[site]


def _stream_opt(paths, ckpt=None, n_iter=6):
    RandomGenerator.set_seed(1)
    ds = streaming.StreamingDataSet(paths, decoder=_decoder(Sample),
                                    shuffle_window=4, num_workers=2,
                                    cache=True,
                                    cache_dir=os.path.join(
                                        os.path.dirname(paths[0]), "cache"))
    model = nn.Sequential().add(nn.Linear(3, 5, generator=torch.Generator()
                                          .manual_seed(3))) \
        .add(nn.LogSoftMax())
    opt = (LocalOptimizer(model, ds >> SampleToMiniBatch(4),
                          nn.ClassNLLCriterion(), device="cpu")
           .set_optim_method(SGD(learningrate=0.05, momentum=0.9))
           .set_end_when(Trigger.max_iteration(n_iter)))
    if ckpt is not None:
        opt.set_checkpoint(str(ckpt), Trigger.several_iteration(1))
    seen = []
    place = opt._place

    def spy(item, *a, **k):
        seen.append(np.array(item.input, copy=True))
        return place(item, *a, **k)

    opt._place = spy
    return opt, model, seen


def test_streamed_resume_replays_the_same_batches(tmp_path):
    paths = _shards(tmp_path / "shards", n_shards=3, per=5)   # 4 batches
    opt, ref, ref_seen = _stream_opt(paths, n_iter=8)
    opt.optimize()
    assert len(ref_seen) == 8
    ckpt = tmp_path / "ckpt"
    opt, _, _ = _stream_opt(paths, ckpt, n_iter=8)
    with pytest.raises(TrainingPreempted):
        with faults.inject_faults("sigterm@6"):
            opt.optimize()
    latest = sorted(os.listdir(ckpt))[-1]
    payload = jfile.load(os.path.join(ckpt, latest))   # JAX's loader
    resume = payload["resume"]
    assert resume["mid_epoch"] and resume["stream"]["window"] == 4
    assert set(resume["stream"]) == {"order", "epoch_seed", "window"}
    opt2, model, seen = _stream_opt(paths, ckpt, n_iter=8)
    opt2.optimize(resume="auto")
    assert opt2.state["neval"] == 9
    assert len(seen) == 2
    for got, want in zip(seen, ref_seen[6:]):
        np.testing.assert_array_equal(got, want)
    ref_params = dict(ref.named_parameters())
    for n, p in model.named_parameters():
        assert torch.equal(p, ref_params[n]), n


def test_refusals_name_their_roadmap_items(tmp_path):
    (p,) = _shards(tmp_path, n_shards=1, per=2)
    # the image decoder is the default of both record sources, as in JAX
    assert DataSet.record_files([p]).decoder is recordio.image_record_decoder
    assert DataSet.stream_shards([p]).decoder is recordio.image_record_decoder
    # distributed=True and shard() are ported: the marker the factory
    # reads, and JAX's strided per-host slice of the shards
    from bigdl_tpu_torch.dataset.dataset import is_distributed
    assert is_distributed(DataSet.stream_shards(
        [p], decoder=_decoder(Sample), distributed=True))
    assert is_distributed(recordio.RecordFileDataSet(
        [p], _decoder(Sample), distributed=True))
    assert _stream(streaming, [p], Sample).shard(0, 2).paths == [p]
    with pytest.raises(ValueError, match="got no shards"):
        _stream(streaming, [p], Sample).shard(1, 2)
    with pytest.raises(TypeError, match="not cacheable"):
        sample_cache.encode_record(type("ImageFeature", (), {})())
    assert recordio.encode_image_record(7, b"ab") == \
        jrec.encode_image_record(7, b"ab")


def _defined(path) -> set:
    import ast
    with open(path) as f:
        tree = ast.parse(f.read())
    return {n.name for n in tree.body
            if isinstance(n, (ast.ClassDef, ast.FunctionDef))
            and not n.name.startswith("_")}


@pytest.mark.parametrize("rel", [
    "dataset/recordio.py", "dataset/streaming.py", "dataset/sample_cache.py",
    "models/ssd/ssd.py", "models/ssd/train.py", "models/maskrcnn/maskrcnn.py",
    "obs/access_log.py"])
def test_every_public_definition_is_ported(rel):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    jax_names = _defined(os.path.join(root, "bigdl_tpu", rel))
    port_names = _defined(os.path.join(root, "bigdl_tpu_torch", rel))
    assert sorted(jax_names - port_names) == []
