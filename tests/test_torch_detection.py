"""The port's detection family against the JAX package, on the CPU.

- the box functions (``pairwise_iou``, ``decode_ssd``/``encode_ssd``,
  ``decode_rcnn``, the base anchors) within 1e-6;
- ``nms_mask``: order and keep bits equal to JAX's, with tied scores,
  invalid candidates and a batch of rows; the NMS kernels' plain versions
  (the suppression words and their sweep) equal to the IoU sweep and to
  JAX's keep bits at ragged K, with ties, dead rows and degenerate boxes,
  and the wrappers' refusals;
- ``NormalizeScale``, ``PriorBox``, ``Anchor``, ``Proposal``,
  ``DetectionOutputSSD``, ``RoiPooling``/``RoiAlign`` (avg and max),
  ``FPN``, ``Pooler``, ``BoxHead``, ``MaskHead``, ``RegionProposal`` and
  ``DetectionOutputFrcnn``: outputs within 1e-6 (boxes) or 1e-5 (ROI
  features) of JAX's from the same weights;
- ``match_priors`` and ``MultiBoxCriterion``: loss within 1e-5 and the
  gradients within 1e-4, relative, of ``jax.grad``;
- a small SSD graph (32 px): forward, loss and gradients of every
  parameter against JAX's;
- a small ``MaskRCNN`` (64 × 64, 8 FPN channels): JAX's detections, under
  the margin rule (a detection may differ only where two scores lie within
  1e-6 or an IoU within 1e-5 of its threshold; the test counts them);
- the SSD main on the CPU, and its refusals of ``--distributed`` and
  ``--save`` naming ROADMAP A.6.
"""

import math
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.models.maskrcnn import MaskRCNN as JMaskRCNN
from bigdl_tpu.models.ssd import SSD as JSSD
from bigdl_tpu.nn import detection as jdet
from bigdl_tpu.utils.random_generator import RandomGenerator as JaxRNG
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch import convert
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.kernels import nms as knms
from bigdl_tpu_torch.models.maskrcnn import MaskRCNN
from bigdl_tpu_torch.models.ssd import SSD, detector
from bigdl_tpu_torch.models.ssd import train as ssd_main
from bigdl_tpu_torch.nn import detection as tdet
from bigdl_tpu_torch.utils.table import T


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a))


def _boxes(seed, *lead, scale=1.0):
    r = np.random.default_rng(seed)
    xy = r.uniform(0, 0.7, lead + (2,))
    wh = r.uniform(0.05, 0.3, lead + (2,))
    return (np.concatenate([xy, xy + wh], -1) * scale).astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _jax_boxes(a, b, pri, var, d, dec):
    return (jdet.pairwise_iou(a, b), jdet.decode_ssd(pri, var, d),
            jdet.encode_ssd(pri, var, dec), jdet.decode_rcnn(pri * 100, d))


def test_box_functions_match_jax():
    a, b = _boxes(0, 7), _boxes(1, 5)
    pri, var = _boxes(2, 9), np.tile([0.1, 0.1, 0.2, 0.2], (9, 1)) \
        .astype(np.float32)
    d = np.random.default_rng(3).normal(0, 0.5, (9, 4)).astype(np.float32)
    dec = tdet.decode_ssd(_t(pri), _t(var), _t(d))
    want = jax.jit(_jax_boxes)(a, b, pri, var, d, dec.numpy())
    got = (tdet.pairwise_iou(_t(a), _t(b)), dec,
           tdet.encode_ssd(_t(pri), _t(var), dec),
           tdet.decode_rcnn(_t(pri * 100), _t(d)))
    for g, w, tol in zip(got, want, (1e-6, 1e-6, 1e-5, 1e-6)):
        _close(g, w, tol)
    np.testing.assert_array_equal(
        tdet._generate_base_anchors(16, (0.5, 1, 2), (8, 16, 32)),
        jdet._generate_base_anchors(16, (0.5, 1, 2), (8, 16, 32)))


def _nms_case(seed, k, ties=False, invalid=False):
    r = np.random.default_rng(seed)
    boxes = _boxes(seed, k)
    scores = r.uniform(0, 1, k).astype(np.float32)
    if ties:
        scores = (np.round(scores * 4) / 4).astype(np.float32)
    valid = r.uniform(size=k) > 0.3 if invalid else None
    return boxes, scores, valid


@pytest.mark.parametrize("ties,invalid", [(False, False), (True, False),
                                          (False, True), (True, True)])
def test_nms_mask_matches_jax(ties, invalid):
    rows = [_nms_case(10 * i + 4, 40, ties, invalid) for i in range(3)]
    b, s = (np.stack([r[i] for r in rows]) for i in (0, 1))
    v = np.stack([r[2] for r in rows]) if invalid else np.ones(s.shape, bool)
    for thr in (0.3, 0.5):
        # JAX's function a row, vmapped over the rows in one program
        wo, wk = jax.jit(jax.vmap(lambda b, s, v: jdet.nms_mask(
            b, s, thr, v if invalid else None)))(b, s, v)
        order, keep = nn.nms_mask(_t(b), _t(s), thr,
                                  valid=_t(v) if invalid else None)
        np.testing.assert_array_equal(order.numpy(), np.asarray(wo))
        np.testing.assert_array_equal(keep.numpy(), np.asarray(wk))
        assert all(0 < int(k.sum()) < 40 for k in keep)
    b, s = _t(b), _t(s)
    all_invalid = torch.zeros(2, 40, dtype=torch.bool)
    _, keep = nn.nms_mask(b[:2], s[:2], 0.5, valid=all_invalid)
    assert not keep.any()


def test_nms_sweep_wrapper_refuses_bad_input():
    """``nms_keep``, ``nms_keep_cuda`` and the two word launches refuse a
    bad shape or dtype by name, and a CPU tensor given to a CUDA entry."""
    boxes = torch.zeros(2, 5, 4)
    alive = torch.zeros(2, 5, dtype=torch.bool)
    words = torch.zeros(2, 5, 1, dtype=torch.int64)
    for fn in (knms.nms_keep, knms.nms_keep_cuda):
        with pytest.raises(ValueError, match=r"boxes \(rows, K, 4\)"):
            fn(boxes[..., :3], alive, 0.5)
        with pytest.raises(ValueError, match="bool alive"):
            fn(boxes, torch.zeros(2, 5), 0.5)
        with pytest.raises(ValueError, match=r"alive \(rows, K\)"):
            fn(boxes, alive[:, :4], 0.5)
        with pytest.raises(ValueError, match="float32 boxes"):
            fn(boxes.to(torch.int32), alive, 0.5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        knms.nms_keep_cuda(boxes, alive, 0.5)
    with pytest.raises(ValueError, match=r"boxes \(rows, K, 4\)"):
        knms.nms_mask_words_cuda(boxes[0], alive, 0.5)
    with pytest.raises(ValueError, match="float32 boxes"):
        knms.nms_mask_words_cuda(boxes.double(), alive, 0.5)
    with pytest.raises(ValueError, match="at most 32768"):
        knms.nms_mask_words_cuda(torch.zeros(1, 32769, 4),
                                 torch.zeros(1, 32769, dtype=torch.bool), 0.5)
    with pytest.raises(ValueError, match="bool alive"):
        knms.nms_mask_words_cuda(boxes, alive.float(), 0.5)
    with pytest.raises(ValueError, match=r"alive \(rows, K\)"):
        knms.nms_mask_words_cuda(boxes, alive[:1], 0.5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        knms.nms_mask_words_cuda(boxes, alive, 0.5)
    with pytest.raises(ValueError, match=r"ceil\(K/64\)"):
        knms.nms_sweep_words_cuda(torch.zeros(2, 5, 2, dtype=torch.int64),
                                  alive)
    with pytest.raises(ValueError, match=r"ceil\(K/64\)"):
        knms.nms_sweep_words_cuda(words[0], alive)
    with pytest.raises(ValueError, match="int64 words"):
        knms.nms_sweep_words_cuda(words.int(), alive)
    with pytest.raises(ValueError, match="bool alive"):
        knms.nms_sweep_words_cuda(words, alive.float())
    with pytest.raises(ValueError, match=r"alive \(rows, K\)"):
        knms.nms_sweep_words_cuda(words, alive[:1])
    with pytest.raises(ValueError, match="CUDA tensors"):
        knms.nms_sweep_words_cuda(words, alive)


def _nms_rows(k, seed):
    """Three score-sorted rows of K boxes: one with duplicate boxes, tied
    scores and a pair at IoU exactly 0.5; one of degenerate boxes (zero
    area, inverted, +-inf and NaN coordinates); one dead (every score
    -inf). Scores never increase along a row, +inf first and -inf last,
    so JAX's stable argsort leaves every row in place; a candidate is alive
    iff its score is finite."""
    r = np.random.default_rng(seed)
    boxes = np.stack([_boxes(seed + i, k, scale=8.0) for i in range(3)])
    tied = np.sort(np.round(r.uniform(0, 1, (3, k)) * 4) / 4, -1)[:, ::-1]
    scores = tied.astype(np.float32).copy()
    b = boxes[0]
    b[1::3] = b[0::3][:len(b[1::3])]                 # duplicates: IoU 1
    if k > 5:
        b[4] = [0, 0, 2, 1]                          # IoU(4, 5) = 0.5
        b[5] = [0, 0, 1, 1]
    d = boxes[1]
    bad = [[1, 1, 1, 3], [3, 3, 2, 2], [0, 0, np.inf, 2],
           [-np.inf, 0, 1, 1], [np.nan, 0, 1, 1], [0, 0, 1, np.nan],
           [-np.inf, -np.inf, np.inf, np.inf], [2, 2, 2, 2]]
    for i in range(0, k, 2):
        d[i] = bad[(i // 2) % len(bad)]
    scores[1, 0] = np.inf
    scores[1, k - k // 4:] = -np.inf
    scores[2] = -np.inf
    return boxes.astype(np.float32), scores


@pytest.mark.parametrize("k", [1, 63, 64, 65, 130])
def test_nms_words_sweep_matches_iou_sweep_and_jax(k):
    boxes, scores = _nms_rows(k, 40 + k)
    thr = 0.5
    jo, jk = jax.jit(jax.vmap(jdet.nms_mask, in_axes=(0, 0, None)))(
        boxes, scores, thr)
    np.testing.assert_array_equal(np.asarray(jo),
                                  np.broadcast_to(np.arange(k), (3, k)))
    b, alive = _t(boxes), torch.isfinite(_t(scores))
    words = knms.nms_mask_words_reference(b, alive, thr)
    assert words.shape == (3, k, -(-k // 64)) and words.dtype == torch.int64
    got = knms.nms_sweep_words_reference(words, alive)
    want = knms.nms_sweep_reference(tdet.pairwise_iou(b, b), alive, thr)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    # a dead candidate's bits are never set, and never read by the sweep
    assert not words[2].any()
    every = knms.nms_mask_words_reference(b, torch.ones_like(alive), thr)
    assert torch.equal(words, every & words)
    np.testing.assert_array_equal(
        knms.nms_sweep_words_reference(every, alive).numpy(), got.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(knms.nms_keep(b, alive, thr).numpy(),
                                  np.asarray(jk))
    assert not got[2].any()
    if k > 5:
        assert float(tdet.pairwise_iou(b[0, 4:5], b[0, 5:6])) == 0.5
        assert not int(every[0, 4, 0]) >> 5 & 1      # 0.5 is not > 0.5
        assert 0 < int(got[0].sum()) < k


def test_normalize_prior_anchor_match_jax():
    x = np.random.default_rng(5).normal(size=(2, 6, 4, 5)).astype(np.float32)
    jn = jnn.NormalizeScale(p=2.0, scale=20.0, size=6)
    tn = nn.NormalizeScale(p=2.0, scale=20.0, size=6)
    w = np.random.default_rng(6).normal(size=(2, 6, 4, 5)).astype(np.float32)
    jout, jg = jax.value_and_grad(lambda p: jnp.sum(
        jn.apply(p, {}, jnp.asarray(x))[0] * w))(jn.get_params())
    xt = _t(x).requires_grad_()
    out = (tn(xt) * _t(w)).sum()
    out.backward()
    _close(out.item(), float(jout), 1e-5)
    assert _rel(tn.weight.grad, jg["weight"]) < 1e-4
    pb = dict(min_sizes=[10.0], max_sizes=[20.0], aspect_ratios=[2.0, 3.0],
              clip=True, img_h=40, img_w=48)
    jp = jnn.PriorBox(**pb).forward(jnp.zeros((1, 3, 5, 6)))
    tp = nn.PriorBox(**pb)(torch.zeros(1, 3, 5, 6))
    _close(tp, jp, 1e-6)
    assert nn.PriorBox(**pb).num_priors == jnn.PriorBox(**pb).num_priors
    ja = jnn.Anchor(scales=(2.0, 4.0)).forward(jnp.zeros((1, 3, 4, 5)))
    ta = nn.Anchor(scales=(2.0, 4.0))(torch.zeros(1, 3, 4, 5))
    _close(ta, ja, 1e-6)


def _proposal_inputs(seed, a=3, h=8, w=10):
    r = np.random.default_rng(seed)
    scores = r.normal(size=(1, 2 * a, h, w)).astype(np.float32)
    deltas = r.normal(0, 0.3, (1, 4 * a, h, w)).astype(np.float32)
    info = np.array([[h * 16.0, w * 16.0, 1.0]], np.float32)
    return scores, deltas, info


def test_proposal_matches_jax():
    kw = dict(pre_nms_topn=60, post_nms_topn=25, scales=(2.0, 4.0),
              rpn_min_size=4.0)
    xs = _proposal_inputs(7, a=6)
    jr, jv = jnn.Proposal(**kw).forward(JT(*map(jnp.asarray, xs))).values()
    tr, tv = nn.Proposal(**kw)(T(*map(_t, xs))).values()
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    _close(tr, jr, 1e-5)
    assert 0 < int(tv.sum()) <= 25


def test_nonzero_static_matches_jnp_nonzero():
    keeps = np.random.default_rng(0).uniform(size=(3, 17)) > 0.5
    for n in (4, 30):
        want = jax.jit(jax.vmap(lambda k: jnp.nonzero(
            k, size=n, fill_value=-1)[0]))(keeps)
        for keep, w in zip(keeps, np.asarray(want)):
            np.testing.assert_array_equal(
                tdet.nonzero_static(_t(keep), n).numpy(), w)


def test_detection_output_ssd_matches_jax():
    n, p, c = 2, 30, 4
    r = np.random.default_rng(8)
    loc = r.normal(0, 0.3, (n, p * 4)).astype(np.float32)
    conf = r.normal(0, 2, (n, p * c)).astype(np.float32)
    pri = np.stack([_boxes(9, p).reshape(-1),
                    np.tile([0.1, 0.1, 0.2, 0.2], p)])[None].astype(np.float32)
    kw = dict(n_classes=c, nms_topk=12, keep_topk=15, conf_thresh=0.2)
    want = jnn.DetectionOutputSSD(**kw).forward(
        JT(*map(jnp.asarray, (loc, conf, pri))))
    got = nn.DetectionOutputSSD(**kw)(T(*map(_t, (loc, conf, pri))))
    _close(got, want, 1e-6)
    kw.update(keep_topk=200)      # the budget beyond the candidates pads
    want = jnn.DetectionOutputSSD(**kw).forward(
        JT(*map(jnp.asarray, (loc, conf, pri))))
    _close(nn.DetectionOutputSSD(**kw)(T(*map(_t, (loc, conf, pri)))),
           want, 1e-6)


def _multibox_inputs(n=3, p=40, c=4, g=3):
    r = np.random.default_rng(11)
    loc = r.normal(0, 0.5, (n, p * 4)).astype(np.float32)
    conf = r.normal(0, 1, (n, p * c)).astype(np.float32)
    pri = np.stack([_boxes(12, p).reshape(-1),
                    np.tile([0.1, 0.1, 0.2, 0.2], p)])[None].astype(np.float32)
    gt = np.full((n, g, 5), -1.0, np.float32)
    for i in range(n):
        for j in range(g - i % 2):   # padding rows in every other image
            gt[i, j, 0] = 1 + (i + j) % (c - 1)
            gt[i, j, 1:] = _boxes(20 + 3 * i + j, 1)[0]
    return loc, conf, pri, gt


def test_multibox_criterion_matches_jax():
    loc, conf, pri, gt = _multibox_inputs()
    jm, jp = jnn.match_priors(jnp.asarray(pri[0, 0].reshape(-1, 4)),
                              jnp.asarray(gt[0, :, 1:]),
                              jnp.asarray(gt[0, :, 0] > 0), 0.5)
    tm, tp = nn.match_priors(_t(pri[0, 0].reshape(-1, 4)), _t(gt[0, :, 1:]),
                             _t(gt[0, :, 0] > 0), 0.5)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    jc = jnn.MultiBoxCriterion(n_classes=4)
    jloss, (gl, gc) = jax.jit(jax.value_and_grad(
        lambda l, c: jc.apply(JT(l, c, jnp.asarray(pri)), jnp.asarray(gt)),
        argnums=(0, 1)))(jnp.asarray(loc), jnp.asarray(conf))
    tl, tc = _t(loc).requires_grad_(), _t(conf).requires_grad_()
    loss = nn.MultiBoxCriterion(n_classes=4)(T(tl, tc, _t(pri)), _t(gt))
    loss.backward()
    assert abs(loss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    assert _rel(tl.grad, gl) < 1e-4 and _rel(tc.grad, gc) < 1e-4


@pytest.mark.parametrize("mode", ["avg", "max"])
def test_roi_pooling_and_align_match_jax(mode):
    r = np.random.default_rng(13)
    feats = r.normal(size=(2, 3, 9, 11)).astype(np.float32)
    rois = np.concatenate([r.integers(0, 2, (6, 1)).astype(np.float32),
                           _boxes(14, 6, scale=40.0)], 1)
    rois[0, 1:] = [-5.0, -3.0, 60.0, 50.0]    # outside the map: clipped
    for jmod, tmod in (
            (jnn.RoiPooling(3, 2, 0.25, 2, mode), nn.RoiPooling(3, 2, 0.25, 2,
                                                               mode)),
            (jnn.RoiAlign(0.25, 2, 3, 2, mode), nn.RoiAlign(0.25, 2, 3, 2,
                                                           mode))):
        want = jmod.forward(JT(jnp.asarray(feats), jnp.asarray(rois)))
        _close(tmod(T(_t(feats), _t(rois))), want, 1e-5)


def _values(out) -> list:
    return list(out.values()) if type(out).__name__ == "Table" else [out]


def _jax_out(jmod, x) -> list:
    """The JAX module's eval output as a list, one compiled program."""
    fn = jax.jit(lambda p, s, x: _values(jmod.apply(p, s, x,
                                                    training=False)[0]))
    return fn(jmod.get_params(), jmod.get_state(), x)


def test_fpn_pooler_heads_match_jax():
    JaxRNG.set_seed(15)
    r = np.random.default_rng(16)
    chans, sizes = (4, 6, 8), (16, 8, 4)
    xs = [r.normal(size=(1, c, s, s)).astype(np.float32)
          for c, s in zip(chans, sizes)]
    jfpn = jnn.FPN(list(chans), 5, top_blocks=1)
    tfpn = nn.FPN(list(chans), 5, top_blocks=1)
    convert.load_jax_params(tfpn, _np(jfpn.get_params()))
    jf = _jax_out(jfpn, JT(*map(jnp.asarray, xs)))
    tf = tfpn(T(*map(_t, xs))).values()
    for a, b in zip(tf, jf):
        _close(a.detach(), b, 1e-5)
    feats3 = [np.asarray(f) for f in list(jf)[:3]]
    rois = np.concatenate([np.zeros((7, 1), np.float32),
                           _boxes(17, 7, scale=64.0)], 1)
    rois[1, 1:] = [0.0, 0.0, 60.0, 63.0]      # a large ROI: a coarse level
    scales = [1 / 4, 1 / 8, 1 / 16]
    jin = JT(JT(*map(jnp.asarray, feats3)), jnp.asarray(rois))
    tin = T(T(*map(_t, feats3)), _t(rois))
    _close(nn.Pooler(3, scales, 2)(tin),
           jnn.Pooler(3, scales, 2).forward(jin), 1e-5)
    for jh, th in ((jnn.BoxHead(5, 3, scales, 2, 4, representation=16),
                    nn.BoxHead(5, 3, scales, 2, 4, representation=16)),
                   (jnn.MaskHead(5, 3, scales, 2, 4, layers=(6, 6)),
                    nn.MaskHead(5, 3, scales, 2, 4, layers=(6, 6)))):
        convert.load_jax_params(th, _np(jh.get_params()))
        want, got = _jax_out(jh, jin), _values(th(tin))
        for a, b in zip(got, want):
            _close(a.detach(), b, 1e-5)


def test_region_proposal_and_frcnn_output_match_jax():
    JaxRNG.set_seed(18)
    r = np.random.default_rng(19)
    feats = [r.normal(size=(1, 6, s, s)).astype(np.float32)
             for s in (16, 8, 4)]
    info = np.array([[64.0, 64.0, 1.0]], np.float32)
    kw = dict(anchor_sizes=(8, 16, 32), feat_strides=(4, 8, 16),
              pre_nms_topn=90, post_nms_topn=30, rpn_min_size=2)
    jrpn, trpn = jnn.RegionProposal(6, **kw), nn.RegionProposal(6, **kw)
    convert.load_jax_params(trpn, _np(jrpn.get_params()))
    jr, jv = _jax_out(jrpn, JT(JT(*map(jnp.asarray, feats)),
                               jnp.asarray(info)))
    with torch.no_grad():
        tr, tv = trpn(T(T(*map(_t, feats)), _t(info))).values()
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    _close(tr, jr, 1e-4)
    c, rr = 5, 30
    logits = r.normal(0, 2, (rr, c)).astype(np.float32)
    deltas = r.normal(0, 0.2, (rr, 4 * c)).astype(np.float32)
    rois = np.asarray(jr)
    valid = np.asarray(jv)
    jd, jdv = jnn.DetectionOutputFrcnn(c, max_per_image=12).forward(
        JT(*map(jnp.asarray, (logits, deltas, rois, info, valid)))).values()
    td, tdv = nn.DetectionOutputFrcnn(c, max_per_image=12)(
        T(*map(_t, (logits, deltas, rois, info, valid)))).values()
    np.testing.assert_array_equal(tdv.numpy(), np.asarray(jdv))
    _close(td, jd, 1e-5)
    jd, _ = jnn.DetectionOutputFrcnn(c, max_per_image=400).forward(
        JT(*map(jnp.asarray, (logits, deltas, rois, info)))).values()
    td, _ = nn.DetectionOutputFrcnn(c, max_per_image=400)(
        T(*map(_t, (logits, deltas, rois, info)))).values()
    _close(td, jd, 1e-5)


@pytest.fixture(scope="module")
def ssd_pair():
    JaxRNG.set_seed(23)
    j = JSSD(3, img_size=32, base_channels=(4, 8, 8),
             aspect_ratios=(2.0,))
    t = SSD(3, img_size=32, base_channels=(4, 8, 8), aspect_ratios=(2.0,),
            device="cpu")
    convert.load_jax_params(t, _np(j.get_params()))
    return j, t


def _ssd_batch(n=2, img=32, seed=24):
    from bigdl_tpu_torch.models.ssd.train import make_dataset
    s = make_dataset(n, img, np.random.RandomState(seed))
    return (np.stack([x.feature[0] for x in s]),
            np.stack([x.label[0] for x in s]))


def test_ssd_forward_loss_and_gradients_match_jax(ssd_pair):
    j, t = ssd_pair
    x, gt = _ssd_batch()
    crit_j = jnn.MultiBoxCriterion(n_classes=3)
    params, state = j.get_params(), j.get_state()

    def jloss(p):
        out, _ = j.apply(p, state, jnp.asarray(x), training=True)
        return crit_j.apply(out, jnp.asarray(gt)), _values(out)

    (jl, jout), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    t.train()
    out = t(_t(x))
    for a, b in zip(out.values(), jout):
        _close(a.detach(), b, 1e-5)
    loss = nn.MultiBoxCriterion(n_classes=3)(out, _t(gt))
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    jflat = convert.flatten_tree(_np(jg))
    for name, p in t.named_parameters():
        assert _rel(p.grad, jflat[name]) < 1e-4, name
    t.zero_grad()


def test_ssd_detector_matches_jax(ssd_pair):
    j, t = ssd_pair
    x, _ = _ssd_batch(3, seed=25)
    from bigdl_tpu.models.ssd import detector as jdetector
    want = jdetector(j, 3, keep_topk=10, conf_thresh=0.01)(jnp.asarray(x))
    got = detector(t, 3, keep_topk=10, conf_thresh=0.01)(_t(x))
    _close(got, want, 1e-5)


def _margin_mismatches(got, want, thr):
    """Rows of ``got`` that differ from JAX's, each of which must be
    explained by a near-tie: a score within 1e-6 of another, or an IoU
    with a detection of its class within 1e-5 of the NMS threshold."""
    diff = ~np.all(np.isclose(got, want, rtol=1e-5, atol=1e-5), axis=1)
    left_out = 0
    for i in np.nonzero(diff)[0]:
        row = want[i]
        others = np.delete(want, i, axis=0)
        tie = np.any(np.abs(others[:, 1] - row[1]) < 1e-6)
        same = others[others[:, 0] == row[0]]
        iou = np.asarray(jdet.pairwise_iou(jnp.asarray(row[None, 2:]),
                                           jnp.asarray(same[:, 2:])))
        near = np.any(np.abs(iou - thr) < 1e-5) if same.size else False
        assert tie or near, (i, got[i], row)
        left_out += 1
    return left_out


def test_maskrcnn_detections_match_jax():
    JaxRNG.set_seed(27)
    kw = dict(image_size=(64, 64), out_channels=8, post_nms_topn=30,
              max_per_image=10)
    j = JMaskRCNN(5, **kw).evaluate()
    t = MaskRCNN(5, **kw, device="cpu")
    convert.load_jax_params(t, _np(j.get_params()))
    t.evaluate()
    img = np.random.default_rng(28).normal(size=(1, 3, 64, 64)) \
        .astype(np.float32)
    jd, jv, jmasks = j.forward(jnp.asarray(img)).values()
    with torch.no_grad():
        td, tv, tmasks = t(_t(img)).values()
    jd, td = np.asarray(jd), td.numpy()
    assert int(np.asarray(jv).sum()) > 0
    left_out = _margin_mismatches(td, jd, 0.5)
    print(f"Mask R-CNN: {left_out} detections left out by the margin rule")
    same = np.all(np.isclose(td, jd, rtol=1e-5, atol=1e-5), axis=1)
    _close(tmasks.numpy()[same], np.asarray(jmasks)[same], 1e-4)
    with pytest.raises(ValueError, match="inference"):
        MaskRCNN(5, **kw, device="cpu")(_t(img))
    with pytest.raises(ValueError, match="compiled for 64x64"):
        t(torch.zeros(1, 3, 32, 32))


def test_ssd_main_on_the_cpu_and_its_refusals():
    saved = os.path.join(tempfile.mkdtemp(), "ssd.bdlm")
    iou = ssd_main.main(["--device", "cpu", "--max-epoch", "2", "--n-train",
                         "32", "-b", "16", "--img-size", "32",
                         "--save", saved])
    assert math.isfinite(iou) and 0.0 <= iou <= 1.0
    assert os.path.exists(saved)
    # --distributed is ported (DistriOptimizer): nothing is refused
    assert not hasattr(ssd_main, "UNPORTED_FLAGS")
    assert ssd_main.build_parser().parse_args(["--distributed"]).distributed
