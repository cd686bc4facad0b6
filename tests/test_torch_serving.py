"""The port's ServingEngine against the JAX engine, on the CPU.

Both engines serve the same weights (copied by path) and the same six
mixed-length requests on three slots, so slots are recycled mid-flight;
their tokens must agree exactly, and each must equal the port's solo
``greedy_generate``. Plus the host-side pieces: scheduler, bucket grid,
admission queue, shutdown and eos.
"""

import threading

import numpy as np
import pytest
import torch

from bigdl_tpu.models.transformerlm import TransformerLM as JaxTransformerLM
from bigdl_tpu.serving import ServingEngine as JaxServingEngine
from bigdl_tpu.utils.random_generator import RandomGenerator
from bigdl_tpu_torch import nn as tnn
from bigdl_tpu_torch.convert import load_jax_params
from bigdl_tpu_torch.models.transformerlm import TransformerLM
from bigdl_tpu_torch.serving import (
    EngineShutdown, ServingEngine, SlotScheduler, default_buckets,
    pick_bucket,
)
from bigdl_tpu_torch.serving.request import Request
from bigdl_tpu_torch.utils.queues import CLOSED, EMPTY, ClosableQueue

VOCAB, MAX_LEN = 64, 64


@pytest.fixture(scope="module")
def pair():
    RandomGenerator.set_seed(7)
    jlm = JaxTransformerLM(VOCAB, embed_dim=32, num_heads=4, num_layers=2,
                           max_len=MAX_LEN).evaluate()
    tlm = TransformerLM(VOCAB, 32, 4, 2, MAX_LEN, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    load_jax_params(tlm, jlm.get_params())
    return jlm, tlm


def _requests(seed=0, n=6):
    r = np.random.default_rng(seed)
    lengths = [3, 29, 12, 40, 7, 18][:n]
    return [(r.integers(0, VOCAB, L).astype(np.int32), int(m))
            for L, m in zip(lengths, r.integers(4, 12, n))]


def test_tokens_match_jax_engine_and_solo_decode(pair):
    jlm, tlm = pair
    reqs = _requests()
    with JaxServingEngine(jlm, MAX_LEN, slots=3) as jeng:
        want = [h.result(120).tokens for h in
                [jeng.submit(p, m) for p, m in reqs]]
    with ServingEngine(tlm, MAX_LEN, slots=3, device="cpu") as eng:
        got = [h.result(120) for h in [eng.submit(p, m) for p, m in reqs]]
        stats = eng.stats()
    for (p, m), w, g in zip(reqs, want, got):
        np.testing.assert_array_equal(g.tokens, np.asarray(w))
        solo = tnn.greedy_generate(tlm, p[None], m, device="cpu")[0]
        np.testing.assert_array_equal(g.tokens, solo.numpy())
        assert g.n_generated == m and g.finish_reason == "length"
        assert g.ttft_s is not None and g.ttft_s <= g.latency_s
    assert stats["completed"] == 6 and stats["prefills"] == 6
    assert stats["slot_recycles"] == 3
    # each request's first token comes from its prefill, the rest from ticks
    assert stats["decode_tokens"] == sum(m for _, m in reqs) - len(reqs)
    assert stats["decode_seconds"] > 0 and stats["prefill_seconds"] > 0


def test_compiled_programs_match_jax_engine(pair):
    """Prompts in three buckets of the default grid (16, 32, 64): both
    engines use one prefill program per bucket, one decode and one assign
    program, and report them against the same bound; tokens equal
    ``greedy_generate``."""
    jlm, tlm = pair
    reqs = [(p, 5) for p, _ in _requests(seed=3)]   # lengths 3..40
    with JaxServingEngine(jlm, MAX_LEN, slots=3) as jeng:
        for h in [jeng.submit(p, m) for p, m in reqs]:
            h.result(120)
        want = jeng.stats()
    with ServingEngine(tlm, MAX_LEN, slots=3, device="cpu") as eng:
        got = [h.result(120) for h in [eng.submit(p, m) for p, m in reqs]]
        stats = eng.stats()
    used = {pick_bucket(len(p), eng.buckets) for p, _ in reqs}
    assert len(used) == 3
    assert stats["compiled_programs"] == want["compiled_programs"] \
        == len(used) + 2
    assert stats["program_grid_bound"] == want["program_grid_bound"] \
        == len(eng.buckets) + 2
    assert eng._programs.keys[:2] == [
        ("serve_prefill", pick_bucket(len(reqs[0][0]), eng.buckets), MAX_LEN,
         "float32"), ("serve_assign", 3, MAX_LEN, "float32")]
    for (p, m), r in zip(reqs, got):
        solo = tnn.greedy_generate(tlm, p[None], m, device="cpu")[0]
        np.testing.assert_array_equal(r.tokens, solo.numpy())


def test_run_updates_the_decode_state_in_place(pair):
    """A captured program replays over the same buffers, so ``run()``
    keeps the decode state's tensor objects and advances ``pos`` and
    ``pos_idx`` in place."""
    _, tlm = pair
    state = tnn.install_decode_cache(tlm, 2, MAX_LEN)
    leaves = {}

    def walk(tree, path=()):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                leaves[path + (k,)] = v

    walk(state)
    before = dict(leaves)
    tok = torch.from_numpy(np.array([[3, 5, 7], [1, 2, 4]]))
    with torch.no_grad():
        _, new = tlm.run(tok, state)
        _, new = tlm.run(tok[:, :1], new)
    leaves.clear()
    walk(new)
    assert leaves.keys() == before.keys()
    for path, leaf in leaves.items():
        assert leaf is before[path], path
        if path[-1] in ("pos", "pos_idx"):
            assert leaf.tolist() == [4, 4], path
    tnn.restart_decode_cache(new, torch.zeros(1, dtype=torch.long))
    assert all(not leaf.any() for leaf in leaves.values())


def test_assign_cache_slot_takes_device_indices(pair):
    """One assign program serves every slot: ``slot`` and ``pos`` as
    one-element tensors give what the ints give."""
    _, tlm = pair
    src = tnn.install_decode_cache(tlm, 1, MAX_LEN)
    with torch.no_grad():
        tlm.run(torch.arange(6)[None], src)
    by_int = tnn.install_decode_cache(tlm, 3, MAX_LEN)
    by_tensor = tnn.install_decode_cache(tlm, 3, MAX_LEN)
    tnn.assign_cache_slot(by_int, src, 2, pos=4)
    tnn.assign_cache_slot(by_tensor, src, torch.tensor([2]),
                          pos=torch.tensor(4))
    flat_int, flat_tensor = [], []
    for tree, out in ((by_int, flat_int), (by_tensor, flat_tensor)):
        stack = [tree]
        while stack:
            node = stack.pop()
            for v in node.values():
                (stack.append if isinstance(v, dict) else out.append)(v)
    for a, b in zip(flat_int, flat_tensor):
        assert torch.equal(a, b)
    assert by_tensor["1"]["pos_idx"].tolist() == [0, 0, 4]
    with pytest.raises(ValueError):
        tnn.assign_cache_slot(by_tensor, src, torch.tensor([1, 2]))


def test_concurrent_clients(pair):
    _, tlm = pair
    reqs = _requests(seed=1)
    handles = [None] * len(reqs)
    with ServingEngine(tlm, MAX_LEN, slots=2, device="cpu") as eng:
        def client(c):
            for i in range(c, len(reqs), 3):
                handles[i] = eng.submit(*reqs[i], request_id=i)
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
            assert not t.is_alive()
        results = [h.result(120) for h in handles]
    for (p, m), r in zip(reqs, results):
        solo = tnn.greedy_generate(tlm, p[None], m, device="cpu")[0]
        np.testing.assert_array_equal(r.tokens, solo.numpy())


def test_eos_finishes_early(pair):
    _, tlm = pair
    p, _ = _requests()[0]
    solo = tnn.greedy_generate(tlm, p[None], 6, device="cpu")[0].numpy()
    eos = int(solo[len(p) + 2])
    with ServingEngine(tlm, MAX_LEN, slots=2, eos_id=eos,
                       device="cpu") as eng:
        r = eng.submit(p, 6).result(60)
    stop = list(solo[len(p):]).index(eos) + 1
    assert r.finish_reason == "eos" and r.n_generated == stop
    np.testing.assert_array_equal(r.tokens, solo[:len(p) + stop])


def test_submit_validation_and_shutdown(pair):
    _, tlm = pair
    eng = ServingEngine(tlm, MAX_LEN, slots=2, buckets=(16, 32),
                        device="cpu")
    with pytest.raises(ValueError):
        eng.submit(np.arange(60) % VOCAB, 10)          # exceeds max_len
    with pytest.raises(ValueError):
        eng.submit(np.arange(40) % VOCAB, 4)           # exceeds buckets
    with pytest.raises(ValueError):
        eng.submit([], 4)
    h = eng.submit(np.arange(5), 3)
    assert h.result(60).n_generated == 3
    eng.shutdown()
    with pytest.raises(EngineShutdown):
        eng.submit(np.arange(5), 3)
    assert not eng.stats()["running"]


def test_engine_requires_the_models_device(pair):
    _, tlm = pair
    with pytest.raises(ValueError):
        ServingEngine(tlm, MAX_LEN, device="meta")


def test_default_buckets_and_pick():
    assert default_buckets(100) == (16, 32, 64, 100)
    assert default_buckets(1024) == (16, 32, 64, 128, 256, 512, 1024)
    assert pick_bucket(17, (16, 32)) == 32 and pick_bucket(33, (16, 32)) is None


def test_slot_scheduler_recycles_fifo():
    s = SlotScheduler(2)
    a = s.admit(Request(0, np.arange(3, dtype=np.int32), 2))
    b = s.admit(Request(1, np.arange(3, dtype=np.int32), 2))
    assert not s.has_free() and s.active_count == 2
    s.release(b)
    s.release(a)
    assert s.admit(Request(2, np.arange(3, dtype=np.int32), 2)).index == 1
    assert s.recycles == 1
    with pytest.raises(RuntimeError):
        s.release(a)                                   # already free


def test_closable_queue_wakes_and_keeps_items():
    q = ClosableQueue(2)
    assert q.get(timeout=0) is EMPTY
    assert q.put(1) and q.put(2)
    got = []
    t = threading.Thread(target=lambda: got.append(q.put(3)))
    t.start()
    q.close()
    t.join(5)
    assert got == [False]
    assert [q.get(timeout=0), q.get(timeout=0)] == [1, 2]
    assert q.get() is CLOSED
