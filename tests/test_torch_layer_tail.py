"""The port's layer tail against the JAX package, on the CPU.

Same weights (moved across by path with ``convert.load_jax_params``,
perturbed first where JAX's init is degenerate), same numpy inputs made
from a seed, small sizes (widths <= 32, spatial <= 12, batch <= 4). Each
case of ``CASES`` compares the output and the gradients of ``sum(out *
w)`` with respect to every parameter and every floating input
(``jax.grad`` against autograd): outputs within 1e-5 (absolute and
relative), gradients within 1e-4 relative (Frobenius norm of the
difference over the norm of JAX's). The cases cover the activations, the
shape and table layers, ``nn/misc.py``, the normalization tail,
``nn/cosine.py``, ``TemporalAveragePooling``, the convolution tail and
``nn/volumetric.py`` and ``nn/tf_utils.py``; a layout-dependent layer runs
in NCHW and NHWC. Inputs are continuous draws from a seed: no element
lies on a kink (0 for ReLU6, Abs, the shrinks and thresholds, the clamps'
bounds) or a tie (``Max``, ``Min``, ``Maxout``, ``CMaxTable``) where
JAX's gradient is a convention, and positive where the function needs it
(``Log``, ``Sqrt``, ``Power``).

The random layers (``RReLU``, ``GaussianSampler``, ``GaussianDropout``,
``GaussianNoise``, ``SpatialDropout1D/2D/3D``) equal JAX in eval mode
(cases above); in training mode their draws are held by their statistics
at 10^6 elements (the kept share within 5 sigma of 1 - p, per channel for
the spatial dropouts; the noise's mean and variance within 5 sigma;
RReLU's slopes inside [lower, upper]), the same generator seed draws the
same twice, and ``dropout_generators`` registers their CUDA generators.
Also: the fp32 islands ``SoftMax``/``SoftMin`` on bf16 input (fp32 out,
equal to JAX's bf16 run), the activity penalties (values and gradients
against JAX's ``"penalty"`` state, and through ``LocalOptimizer``'s loss),
``MaskedSelect`` eager and refused under capture, the initializers, and a
name-by-name diff of the twelve JAX files against the port.
"""

import ast
import os
from dataclasses import dataclass
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu import optim as joptim
from bigdl_tpu.dataset import DataSet as JDataSet
from bigdl_tpu.nn import layout as jlayout
from bigdl_tpu.utils import engine as jax_engine
from bigdl_tpu.utils.random_generator import RandomGenerator as JaxRNG
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu.utils.table import Table as JTable
from bigdl_tpu_torch import nn
from bigdl_tpu_torch import optim as toptim
from bigdl_tpu_torch.convert import flatten_tree, load_jax_params
from bigdl_tpu_torch.dataset import DataSet
from bigdl_tpu_torch.nn import layout as tlayout
from bigdl_tpu_torch.nn.containers import MaskedSelectCaptureError
from bigdl_tpu_torch.nn.normalization import dropout_generators
from bigdl_tpu_torch.utils import engine as torch_engine
from bigdl_tpu_torch.utils.table import T, Table

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread_and_reset():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    jlayout.set_image_format(None)
    tlayout.set_image_format(None)
    jax_engine.Engine.reset()
    torch_engine.Engine.reset()


def _x(*shape, seed=0, lo=None, hi=None):
    r = np.random.default_rng(seed)
    if lo is not None:
        return r.uniform(lo, hi, size=shape).astype(np.float32)
    return r.normal(size=shape).astype(np.float32)


def _compiled(fn, *args):
    """``fn(*args)`` as one compiled program (eager JAX compiles op by op),
    compiled without XLA's expensive CPU passes: these tiny programs
    spend far longer compiling than running."""
    return jax.jit(fn).lower(*args).compile(compiler_options={
        "xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True})(*args)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want)
                 / max(np.linalg.norm(want), 1e-30))


@dataclass
class Case:
    build: Callable                  # pkg -> module
    inputs: Callable                 # nhwc -> nested lists of arrays
    layout: bool = False             # run in NCHW and NHWC
    perturb: bool = False            # noise on JAX's init first
    train: bool = False              # both in training mode


def _img(n, c, h, w, nhwc, seed=0):
    return _x(n, h, w, c, seed=seed) if nhwc else _x(n, c, h, w, seed=seed)


def _pos(*shape, seed=0):
    return _x(*shape, seed=seed, lo=0.2, hi=2.0)


B, C, H, W = 2, 3, 6, 5

CASES = {
    # --- nn/activation.py
    "Abs": Case(lambda p: p.Abs(), lambda _: _x(B, 7)),
    "AddConstant": Case(lambda p: p.AddConstant(0.5), lambda _: _x(B, 7)),
    "BinaryThreshold": Case(lambda p: p.BinaryThreshold(0.1),
                            lambda _: _x(B, 7)),
    "Clamp": Case(lambda p: p.Clamp(-0.5, 0.7), lambda _: _x(B, 7)),
    "ELU": Case(lambda p: p.ELU(0.8), lambda _: _x(B, 7)),
    "Exp": Case(lambda p: p.Exp(), lambda _: _x(B, 7)),
    "HardSigmoid": Case(lambda p: p.HardSigmoid(), lambda _: 4 * _x(B, 7)),
    "HardTanh": Case(lambda p: p.HardTanh(-0.6, 0.8), lambda _: _x(B, 7)),
    "LeakyReLU": Case(lambda p: p.LeakyReLU(0.05), lambda _: _x(B, 7)),
    "Log": Case(lambda p: p.Log(), lambda _: _pos(B, 7)),
    "LogSigmoid": Case(lambda p: p.LogSigmoid(), lambda _: _x(B, 7)),
    "MulConstant": Case(lambda p: p.MulConstant(1.5), lambda _: _x(B, 7)),
    "PReLU-shared": Case(lambda p: p.PReLU(), lambda _: _x(B, 7),
                         perturb=True),
    "PReLU-features": Case(lambda p: p.PReLU(7), lambda _: _x(B, 7),
                           perturb=True),
    "PReLU-channels": Case(lambda p: p.PReLU(C),
                           lambda f: _img(B, C, H, W, f), layout=True,
                           perturb=True),
    "Power": Case(lambda p: p.Power(2.5, 0.5, 2.0), lambda _: _x(B, 7)),
    "ReLU6": Case(lambda p: p.ReLU6(), lambda _: 5 * _x(B, 7)),
    "SReLU": Case(lambda p: p.SReLU((7,)), lambda _: 2 * _x(B, 7),
                  perturb=True),
    "SReLU-shared": Case(lambda p: p.SReLU((4, 5, C), shared_axes=(1, 2)),
                         lambda _: 2 * _x(B, 4, 5, C), perturb=True),
    "Sigmoid": Case(lambda p: p.Sigmoid(), lambda _: _x(B, 7)),
    "SoftMax": Case(lambda p: p.SoftMax(), lambda _: _x(B, 3, 7)),
    "SoftMin": Case(lambda p: p.SoftMin(), lambda _: _x(B, 7)),
    "SoftPlus": Case(lambda p: p.SoftPlus(2.0), lambda _: 8 * _x(B, 7)),
    "SoftSign": Case(lambda p: p.SoftSign(), lambda _: _x(B, 7)),
    "Sqrt": Case(lambda p: p.Sqrt(), lambda _: _pos(B, 7)),
    "Square": Case(lambda p: p.Square(), lambda _: _x(B, 7)),
    "TanhShrink": Case(lambda p: p.TanhShrink(), lambda _: _x(B, 7)),
    # --- nn/shape_ops.py
    "Flatten": Case(lambda p: p.Flatten(), lambda _: _x(B, 2, 3, 4)),
    "Unsqueeze": Case(lambda p: p.Unsqueeze(2), lambda _: _x(B, 3, 4)),
    "Transpose": Case(lambda p: p.Transpose([(1, 3), (2, 3)]),
                      lambda _: _x(B, 3, 4)),
    "Narrow": Case(lambda p: p.Narrow(2, 2, 3), lambda _: _x(B, 6, 2)),
    "Narrow-negative": Case(lambda p: p.Narrow(-1, 2, -2),
                            lambda _: _x(B, 3, 6)),
    "SplitTable": Case(lambda p: p.SplitTable(2), lambda _: _x(B, 3, 4)),
    "SplitTable-batched": Case(lambda p: p.SplitTable(1, 2),
                               lambda _: _x(B, 3, 4)),
    "Padding-before": Case(lambda p: p.Padding(2, -2, value=0.5),
                           lambda _: _x(B, 3, 4)),
    "Padding-batched": Case(lambda p: p.Padding(1, 3, num_input_dims=2),
                            lambda _: _x(B, 3, 4)),
    "SpatialZeroPadding": Case(lambda p: p.SpatialZeroPadding(1, 2, 0, 1),
                               lambda _: _x(B, C, H, W)),
    "Contiguous": Case(lambda p: p.Contiguous(), lambda _: _x(B, 5)),
    "Replicate": Case(lambda p: p.Replicate(3, 2), lambda _: _x(B, 5)),
    "Replicate-batched": Case(lambda p: p.Replicate(3, 1, 1),
                              lambda _: _x(B, 5)),
    "Tile": Case(lambda p: p.Tile(2, 3), lambda _: _x(B, 2, 3)),
    "Reverse": Case(lambda p: p.Reverse(2), lambda _: _x(B, 4, 3)),
    "Index": Case(lambda p: p.Index(2), lambda _: [
        _x(B, 5, 3), np.array([[0, 4, -1], [-5, 5, -6]], np.int32)]),
    "InferReshape": Case(lambda p: p.InferReshape([0, -1, 2]),
                         lambda _: _x(B, 3, 4)),
    "InferReshape-batched": Case(
        lambda p: p.InferReshape([-1, 0], batch_mode=True),
        lambda _: _x(B, 3, 4)),
    # --- nn/containers.py
    "ParallelTable": Case(lambda p: p.ParallelTable().add(p.Linear(4, 3))
                          .add(p.Tanh()),
                          lambda _: [_x(B, 4), _x(B, 5, seed=1)]),
    "MapTable": Case(lambda p: p.MapTable(p.Linear(4, 3)),
                     lambda _: [_x(B, 4), _x(B, 4, seed=1), _x(1, 4, seed=2)]),
    "NarrowTable": Case(lambda p: p.NarrowTable(2, 2), lambda _: [
        _x(B, 3), _x(B, 3, seed=1), _x(B, 3, seed=2)]),
    "NarrowTable-one": Case(lambda p: p.NarrowTable(3, 1), lambda _: [
        _x(B, 3), _x(B, 3, seed=1), _x(B, 3, seed=2)]),
    "FlattenTable": Case(lambda p: p.FlattenTable(), lambda _: [
        _x(B, 3), [_x(B, 2, seed=1), [_x(4, seed=2)]], _x(1, seed=3)]),
    "CSubTable": Case(lambda p: p.CSubTable(),
                      lambda _: [_x(B, 4), _x(B, 4, seed=1)]),
    "CDivTable": Case(lambda p: p.CDivTable(),
                      lambda _: [_x(B, 4), _pos(B, 4, seed=1)]),
    "CMaxTable": Case(lambda p: p.CMaxTable(), lambda _: [
        _x(B, 4), _x(B, 4, seed=1), _x(B, 4, seed=2)]),
    "CMinTable": Case(lambda p: p.CMinTable(), lambda _: [
        _x(B, 4), _x(B, 4, seed=1), _x(B, 4, seed=2)]),
    "CAveTable": Case(lambda p: p.CAveTable(), lambda _: [
        _x(B, 4), _x(B, 4, seed=1), _x(B, 4, seed=2)]),
    "MixtureTable": Case(lambda p: p.MixtureTable(), lambda _: [
        _x(B, 3), [_x(B, 4, seed=1), _x(B, 4, seed=2), _x(B, 4, seed=3)]]),
    "MixtureTable-stacked": Case(lambda p: p.MixtureTable(3), lambda _: [
        _x(B, 3), _x(B, 5, 3, seed=1)]),
    "Bottle": Case(lambda p: p.Bottle(p.Linear(4, 3), 2),
                   lambda _: _x(B, 3, 4)),
    "Pack": Case(lambda p: p.Pack(2), lambda _: [_x(B, 4), _x(B, 4, seed=1)]),
    "Echo": Case(lambda p: p.Echo(), lambda _: _x(B, 4)),
    "BifurcateSplitTable": Case(lambda p: p.BifurcateSplitTable(2),
                                lambda _: _x(B, 6)),
    # --- nn/misc.py
    "Max": Case(lambda p: p.Max(2), lambda _: _x(B, 5, 3)),
    "Max-batched": Case(lambda p: p.Max(1, 1), lambda _: _x(B, 5)),
    "Min": Case(lambda p: p.Min(-1), lambda _: _x(B, 5, 3)),
    "Mean": Case(lambda p: p.Mean(2), lambda _: _x(B, 5, 3)),
    "Sum": Case(lambda p: p.Sum(2, size_average=True),
                lambda _: _x(B, 5, 3)),
    "Threshold": Case(lambda p: p.Threshold(0.1, 0.3), lambda _: _x(B, 7)),
    "HardShrink": Case(lambda p: p.HardShrink(0.4), lambda _: _x(B, 7)),
    "SoftShrink": Case(lambda p: p.SoftShrink(0.4), lambda _: _x(B, 7)),
    "RReLU": Case(lambda p: p.RReLU(), lambda _: _x(B, 7)),
    "Negative": Case(lambda p: p.Negative(), lambda _: _x(B, 7)),
    "DotProduct": Case(lambda p: p.DotProduct(),
                       lambda _: [_x(B, 5), _x(B, 5, seed=1)]),
    "MM": Case(lambda p: p.MM(True, False),
               lambda _: [_x(B, 4, 3), _x(B, 4, 5, seed=1)]),
    "MM-b": Case(lambda p: p.MM(False, True),
                 lambda _: [_x(3, 4), _x(5, 4, seed=1)]),
    "MV": Case(lambda p: p.MV(True), lambda _: [_x(B, 4, 3), _x(B, 4, seed=1)]),
    "Euclidean": Case(lambda p: p.Euclidean(5, 3), lambda _: _x(B, 5)),
    "Bilinear": Case(lambda p: p.Bilinear(4, 5, 3),
                     lambda _: [_x(B, 4), _x(B, 5, seed=1)], perturb=True),
    "Maxout": Case(lambda p: p.Maxout(6, 4, 3), lambda _: _x(B, 6)),
    "SpatialUpSamplingNearest": Case(lambda p: p.SpatialUpSamplingNearest(2),
                                     lambda _: _x(B, C, 4, 3)),
    "SpatialUpSamplingBilinear": Case(
        lambda p: p.SpatialUpSamplingBilinear(2), lambda _: _x(B, C, 4, 3)),
    "SpatialUpSamplingBilinear-3d": Case(
        lambda p: p.SpatialUpSamplingBilinear(3), lambda _: _x(C, 4, 3)),
    "GradientReversal": Case(lambda p: p.GradientReversal(0.7),
                             lambda _: _x(B, 5)),
    "L1Penalty": Case(lambda p: p.L1Penalty(0.1, size_average=True),
                      lambda _: _x(B, 5), train=True),
    "Scale": Case(lambda p: p.Scale((C, 1, 1)), lambda _: _x(B, C, 4, 3),
                  perturb=True),
    "PairwiseDistance": Case(lambda p: p.PairwiseDistance(2),
                             lambda _: [_x(B, 5), _x(B, 5, seed=1)]),
    "PairwiseDistance-l3": Case(lambda p: p.PairwiseDistance(3),
                                lambda _: [_x(5), _x(5, seed=1)]),
    "GaussianSampler": Case(lambda p: p.GaussianSampler(),
                            lambda _: [_x(B, 5), _x(B, 5, seed=1)]),
    "Highway": Case(lambda p: p.Highway(6), lambda _: _x(B, 6),
                    perturb=True),
    "Highway-relu": Case(lambda p: p.Highway(6, activation=p.ReLU()),
                         lambda _: _x(B, 6), perturb=True),
    "UpSampling1D": Case(lambda p: p.UpSampling1D(3), lambda _: _x(B, 4, 3)),
    "UpSampling2D": Case(lambda p: p.UpSampling2D((2, 3)),
                         lambda f: _img(B, C, 3, 4, f), layout=True),
    "UpSampling3D": Case(lambda p: p.UpSampling3D((1, 2, 3)),
                         lambda _: _x(B, 2, 3, 2, 3)),
    "ResizeBilinear-up": Case(lambda p: p.ResizeBilinear(7, 9),
                              lambda _: _x(B, C, 4, 5)),
    "ResizeBilinear-down": Case(lambda p: p.ResizeBilinear(3, 2),
                                lambda _: _x(B, C, 7, 5)),
    "ResizeBilinear-corners": Case(lambda p: p.ResizeBilinear(7, 3, True),
                                   lambda _: _x(B, C, 4, 5)),
    "ResizeBilinear-corners-row": Case(
        lambda p: p.ResizeBilinear(1, 6, True), lambda _: _x(B, C, 4, 5)),
    "ResizeBilinear-3d": Case(lambda p: p.ResizeBilinear(5, 4),
                              lambda _: _x(C, 3, 3)),
    "Cropping2D": Case(lambda p: p.Cropping2D((1, 2), (0, 1)),
                       lambda _: _x(B, C, H, W)),
    "Cropping3D": Case(lambda p: p.Cropping3D((1, 0), (0, 2), (1, 1)),
                       lambda _: _x(B, 2, 3, 4, 5)),
    "ActivityRegularization": Case(
        lambda p: p.ActivityRegularization(0.1, 0.2), lambda _: _x(B, 5)),
    "NegativeEntropyPenalty": Case(lambda p: p.NegativeEntropyPenalty(0.3),
                                   lambda _: _pos(B, 5)),
    "CrossProduct": Case(lambda p: p.CrossProduct(3, 4), lambda _: [
        _x(B, 4), _x(B, 4, seed=1), _x(B, 4, seed=2)]),
    # --- nn/normalization.py's tail, nn/cosine.py, nn/pooling.py
    "Normalize": Case(lambda p: p.Normalize(2.0), lambda _: _x(B, 5)),
    "Normalize-inf": Case(lambda p: p.Normalize(float("inf")),
                          lambda _: _x(B, 5)),
    "Normalize-p1.5": Case(lambda p: p.Normalize(1.5), lambda _: _x(B, 5, 2)),
    "CMul": Case(lambda p: p.CMul((1, C, 1, 1)), lambda _: _x(B, C, 4, 3)),
    "CAdd": Case(lambda p: p.CAdd((C, 1, 1)), lambda _: _x(B, C, 4, 3)),
    "Mul": Case(lambda p: p.Mul(), lambda _: _x(B, 5)),
    "Add": Case(lambda p: p.Add(5), lambda _: _x(B, 5)),
    "SpatialWithinChannelLRN": Case(
        lambda p: p.SpatialWithinChannelLRN(3, 1.5, 0.75),
        lambda _: _x(B, C, H, W)),
    "SpatialSubtractiveNormalization": Case(
        lambda p: p.SpatialSubtractiveNormalization(C, _pos(5, 3, seed=9)),
        lambda _: _x(B, C, H, W)),
    "SpatialDivisiveNormalization": Case(
        lambda p: p.SpatialDivisiveNormalization(C, _pos(5, seed=9)),
        lambda _: _x(B, C, H, W)),
    "SpatialDivisiveNormalization-threshold": Case(
        lambda p: p.SpatialDivisiveNormalization(C, threshold=0.9,
                                                 thresval=0.5),
        lambda _: _x(C, 10, 11)),
    "SpatialContrastiveNormalization": Case(
        lambda p: p.SpatialContrastiveNormalization(C, np.ones((3, 3))),
        lambda _: _x(B, C, H, W)),
    "Cosine": Case(lambda p: p.Cosine(6, 4), lambda _: _x(B, 6)),
    "Cosine-1d": Case(lambda p: p.Cosine(6, 4), lambda _: _x(6)),
    "CosineDistance": Case(lambda p: p.CosineDistance(),
                           lambda _: [_x(B, 5), _x(B, 5, seed=1)]),
    "TemporalAveragePooling": Case(lambda p: p.TemporalAveragePooling(3, 2),
                                   lambda _: _x(B, 8, 4)),
    "TemporalAveragePooling-global": Case(
        lambda p: p.TemporalAveragePooling(-1), lambda _: _x(7, 4)),
    # --- the random layers, eval mode
    "SpatialDropout1D": Case(lambda p: p.SpatialDropout1D(0.3),
                             lambda _: _x(B, 4, 5)),
    "SpatialDropout2D": Case(lambda p: p.SpatialDropout2D(0.3),
                             lambda f: _img(B, C, 4, 3, f), layout=True),
    "SpatialDropout3D": Case(lambda p: p.SpatialDropout3D(0.3),
                             lambda _: _x(B, C, 2, 3, 2)),
    "GaussianDropout": Case(lambda p: p.GaussianDropout(0.3),
                            lambda _: _x(B, 5)),
    "GaussianNoise": Case(lambda p: p.GaussianNoise(0.3), lambda _: _x(B, 5)),
    # --- nn/convolution.py's tail, nn/volumetric.py
    "SpatialDilatedConvolution": Case(
        lambda p: p.SpatialDilatedConvolution(3, 4, 3, 3, 2, 1, 1, 2, 2, 1),
        lambda _: _x(B, 3, 9, 8)),
    "SpatialFullConvolution": Case(
        lambda p: p.SpatialFullConvolution(4, 3, 3, 2, 2, 2, 1, 0, 1, 1),
        lambda _: _x(B, 4, 5, 4)),
    "SpatialFullConvolution-groups": Case(
        lambda p: p.SpatialFullConvolution(4, 6, 3, 3, 1, 2, 1, 1, 0, 1,
                                           n_group=2),
        lambda _: _x(B, 4, 4, 5)),
    "SpatialFullConvolution-wide-adj": Case(
        lambda p: p.SpatialFullConvolution(2, 3, 3, 3, 2, 2, 0, 1, 2, 3,
                                           no_bias=True),
        lambda _: _x(2, 4, 3)),
    "SpatialSeparableConvolution": Case(
        lambda p: p.SpatialSeparableConvolution(3, 4, 2, 3, 3, 1, 2, 1, 0),
        lambda f: _img(B, 3, 7, 6, f), layout=True),
    "SpatialSeparableConvolution-same": Case(
        lambda p: p.SpatialSeparableConvolution(3, 5, 1, 2, 3, 2, 2, -1, -1),
        lambda f: _img(B, 3, 7, 6, f), layout=True),
    "SpatialShareConvolution": Case(
        lambda p: p.SpatialShareConvolution(3, 4, 3, 3, 1, 1, 1, 1),
        lambda f: _img(B, 3, 6, 5, f), layout=True),
    "SpatialConvolutionMap": Case(
        lambda p: p.SpatialConvolutionMap(
            p.SpatialConvolutionMap.random(4, 3, 2, seed=1), 3, 2, 1, 1, 1, 0),
        lambda f: _img(B, 4, 6, 5, f), layout=True),
    "SpatialConvolutionMap-repeats": Case(
        lambda p: p.SpatialConvolutionMap([(1, 1), (2, 1), (1, 1), (2, 2)],
                                          3, 3, 2, 2, -1, -1),
        lambda f: _img(B, 2, 5, 6, f), layout=True),
    "LocallyConnected2D": Case(
        lambda p: p.LocallyConnected2D(3, 7, 6, 4, 3, 2, 2, 1, 1, 0),
        lambda _: _x(B, 3, 6, 7)),
    "LocallyConnected2D-3d": Case(
        lambda p: p.LocallyConnected2D(2, 5, 5, 3, 3, 3),
        lambda _: _x(2, 5, 5)),
    "LocallyConnected1D": Case(
        lambda p: p.LocallyConnected1D(8, 5, 4, 3, 2),
        lambda _: _x(B, 8, 5)),
    "LocallyConnected1D-2d": Case(
        lambda p: p.LocallyConnected1D(6, 3, 2, 2), lambda _: _x(6, 3)),
    "VolumetricConvolution": Case(
        lambda p: p.VolumetricConvolution(2, 3, 2, 3, 3, 1, 2, 1, 1, 1, 0),
        lambda _: _x(B, 2, 4, 6, 5)),
    "VolumetricMaxPooling": Case(
        lambda p: p.VolumetricMaxPooling(2, 3, 2, 1, 2, 2, 1, 1, 0),
        lambda _: _x(B, 2, 4, 5, 6)),
    "VolumetricAveragePooling": Case(
        lambda p: p.VolumetricAveragePooling(2, 2, 3, 2, 1, 2, 0, 1, 1),
        lambda _: _x(2, 5, 6, 7)),
    "VolumetricFullConvolution": Case(
        lambda p: p.VolumetricFullConvolution(4, 2, 2, 3, 2, 2, 1, 2, 0, 1,
                                              1, 1, 0, 1, n_group=2),
        lambda _: _x(B, 4, 3, 3, 4)),
    # --- nn/tf_utils.py
    "Const": Case(lambda p: p.Const(_x(3, 2, seed=5)), lambda _: _x(B, 4)),
    "Fill": Case(lambda p: p.Fill(), lambda _: [
        np.array([2, 3], np.int32), np.array(1.5, np.float32)]),
    "Shape": Case(lambda p: p.Shape(), lambda _: _x(B, 3, 4)),
    "StrideSlice": Case(lambda p: p.StrideSlice([(1, 1, 6, 2), (2, 3, 0, -2)]),
                        lambda _: _x(B, 7, 5)),
    "SplitAndSelect": Case(lambda p: p.SplitAndSelect(1, 2, 3),
                           lambda _: _x(B, 6, 2)),
}


def _pair(case: Case, seed=3):
    """The JAX module and the port's, its weights carried across."""
    JaxRNG.set_seed(seed)
    jm = case.build(jnn)
    tm = case.build(nn)
    if case.perturb:
        r = np.random.default_rng(seed)
        jm.set_params(jax.tree_util.tree_map(
            lambda a: a + r.normal(0, 0.3, a.shape).astype(np.float32),
            jm.get_params()))
    tree = jax.device_get(jm.get_params())
    assert sorted(flatten_tree(tree)) == sorted(
        n for n, _ in tm.named_parameters())
    load_jax_params(tm, tree)
    tm.train(case.train)
    return jm, tm


def _nest(spec, make, leaf):
    if isinstance(spec, list):
        return make(*[_nest(s, make, leaf) for s in spec])
    return leaf(spec)


def _flat(spec) -> list:
    return [a for s in spec for a in _flat(s)] if isinstance(spec, list) \
        else [spec]


def _leaves(out) -> list:
    if isinstance(out, (Table, JTable)):
        return [a for v in out.values() for a in _leaves(v)]
    return [out]


def _check(case: Case, nhwc: bool = False):
    jm, tm = _pair(case)
    spec = case.inputs(nhwc)
    arrays = _flat(spec)
    floating = [i for i, a in enumerate(arrays) if a.dtype.kind == "f"]

    def jinput(floats):
        it = iter(range(len(arrays)))
        # integer inputs stay host constants (Fill's shape must be static)
        vals = {i: floats[floating.index(i)] if i in floating
                else arrays[i] for i in range(len(arrays))}
        return _nest(spec, JT, lambda _: vals[next(it)])

    def japply(p, floats):
        return jm.apply(p, jm.get_state(), jinput(floats),
                        training=case.train)[0]

    floats0 = [jnp.asarray(arrays[i]) for i in floating]

    def jloss(p, floats):
        outs = _leaves(japply(p, floats))
        # a constant 0 without a floating output: every gradient is zero
        return sum(((o * _x(*o.shape, seed=11 + k)).sum()
                    for k, o in enumerate(outs)
                    if jnp.issubdtype(o.dtype, jnp.floating)),
                   jnp.zeros((), jnp.float32)), outs

    (_, want), (gp, gx) = _compiled(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True), jm.get_params(), floats0)
    ws = [_x(*o.shape, seed=11 + k) for k, o in enumerate(want)]
    tensors = [torch.from_numpy(a.copy()) for a in arrays]
    for i in floating:
        tensors[i].requires_grad_()
    it = iter(tensors)
    got = _leaves(tm(_nest(spec, T, lambda _: next(it))))
    assert len(got) == len(want)
    for g, o in zip(got, want):
        assert tuple(g.shape) == tuple(np.shape(o))
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(o),
                                   rtol=1e-5, atol=1e-5)
    params = [p for _, p in tm.named_parameters()]
    wrt = params + [tensors[i] for i in floating]
    loss = sum((g * torch.from_numpy(w)).sum() for g, w in zip(got, ws)
               if g.is_floating_point())
    grads = torch.autograd.grad(loss, wrt, allow_unused=True) \
        if isinstance(loss, torch.Tensor) and loss.requires_grad \
        else [None] * len(wrt)
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, wrt)]
    gp = flatten_tree(jax.device_get(gp))
    for (n, _), g in zip(tm.named_parameters(), grads):
        assert _rel(g.numpy(), gp[n]) <= 1e-4, n
    for g, want_g in zip(grads[len(params):], gx):
        assert _rel(g.numpy(), want_g) <= 1e-4


LAYOUT_CASES = [(n, f) for n, c in sorted(CASES.items())
                for f in ((False, True) if c.layout else (False,))]


@pytest.mark.parametrize(
    "name,nhwc", LAYOUT_CASES,
    ids=[f"{n}-{'NHWC' if f else 'NCHW'}" for n, f in LAYOUT_CASES])
def test_layer_matches_jax(name, nhwc):
    fmt = "NHWC" if nhwc else "NCHW"
    jlayout.set_image_format(fmt)
    tlayout.set_image_format(fmt)
    _check(CASES[name], nhwc)


# ------------------------------------------------------- the random layers
N_DRAW = 10 ** 6


def _within(value, mean, sigma, what):
    assert abs(value - mean) <= 5 * sigma, (what, value, mean, sigma)


@pytest.mark.parametrize("name,shape,p,fmt", [
    ("SpatialDropout1D", (1000, 10, 100), 0.3, "NCHW"),
    ("SpatialDropout2D", (1000, 16, 8, 8), 0.4, "NCHW"),
    ("SpatialDropout2D", (1000, 8, 8, 16), 0.4, "NHWC"),
    ("SpatialDropout3D", (1000, 8, 5, 5, 5), 0.25, "NCHW"),
])
def test_spatial_dropout_keeps_whole_channels_at_the_kept_share(
        name, shape, p, fmt):
    tlayout.set_image_format(fmt)
    m = getattr(nn, name)(p, generator=torch.Generator().manual_seed(1))
    out = m(torch.ones(shape))
    keep = 1.0 - p
    assert set(torch.unique(out).tolist()) <= {
        0.0, float(torch.tensor(1.0) / keep)}
    # one mask per (sample, channel): a channel is kept or dropped whole
    ca = {"SpatialDropout1D": 2, "SpatialDropout3D": 1}.get(
        name, 3 if fmt == "NHWC" else 1)
    axes = tuple(a for a in range(1, len(shape)) if a != ca)
    kept = (out > 0).float()
    lo, hi = kept.amin(axes), kept.amax(axes)
    assert torch.equal(lo, hi)
    n = lo.shape[0]
    for c in range(lo.shape[1]):     # the kept share of every channel
        _within(float(lo[:, c].mean()), keep, (keep * p / n) ** 0.5,
                f"channel {c}")
    m.eval()
    x = torch.randn(shape[:2] + (3,))
    assert m(x) is x


@pytest.mark.parametrize("name", ["GaussianDropout", "GaussianNoise",
                                  "GaussianSampler"])
def test_gaussian_layers_draw_the_right_moments(name):
    g = torch.Generator().manual_seed(2)
    rate, std = 0.3, 0.7
    if name == "GaussianDropout":
        m = nn.GaussianDropout(rate, generator=g)
        out, mean, var = m(torch.ones(N_DRAW)), 1.0, rate / (1 - rate)
    elif name == "GaussianNoise":
        m = nn.GaussianNoise(std, generator=g)
        out, mean, var = m(torch.zeros(N_DRAW)), 0.0, std ** 2
    else:
        m = nn.GaussianSampler(generator=g)
        out = m(T(torch.full((N_DRAW,), 0.5),
                  torch.full((N_DRAW,), 2 * np.log(std))))
        mean, var = 0.5, std ** 2
    assert out.dtype == torch.float32
    _within(float(out.mean()), mean, (var / N_DRAW) ** 0.5, "mean")
    _within(float(out.var()), var, var * (2.0 / N_DRAW) ** 0.5, "variance")


def test_rrelu_slopes_lie_in_their_interval():
    lower, upper = 0.1, 0.4
    m = nn.RReLU(lower, upper, generator=torch.Generator().manual_seed(3))
    slopes = -m(-torch.ones(N_DRAW))
    assert float(slopes.min()) >= lower and float(slopes.max()) <= upper
    _within(float(slopes.mean()), (lower + upper) / 2,
            ((upper - lower) ** 2 / 12 / N_DRAW) ** 0.5, "mean slope")
    x = torch.randn(1000, generator=torch.Generator().manual_seed(4))
    assert torch.equal(m(x)[x >= 0], x[x >= 0])
    m.eval()
    assert torch.equal(m(-torch.ones(3)), -torch.full((3,), 0.25))


RANDOM_LAYERS = {
    "RReLU": (lambda g: nn.RReLU(generator=g), lambda: torch.randn(
        64, 9, generator=torch.Generator().manual_seed(0))),
    "GaussianSampler": (lambda g: nn.GaussianSampler(generator=g),
                        lambda: T(torch.zeros(64, 9), torch.zeros(64, 9))),
    "GaussianDropout": (lambda g: nn.GaussianDropout(0.2, generator=g),
                        lambda: torch.ones(64, 9)),
    "GaussianNoise": (lambda g: nn.GaussianNoise(0.2, generator=g),
                      lambda: torch.zeros(64, 9)),
    "SpatialDropout1D": (lambda g: nn.SpatialDropout1D(0.5, generator=g),
                         lambda: torch.ones(16, 4, 9)),
    "SpatialDropout2D": (lambda g: nn.SpatialDropout2D(0.5, generator=g),
                         lambda: torch.ones(16, 9, 2, 2)),
    "SpatialDropout3D": (lambda g: nn.SpatialDropout3D(0.5, generator=g),
                         lambda: torch.ones(16, 9, 2, 2, 2)),
}


@pytest.mark.parametrize("name", sorted(RANDOM_LAYERS))
def test_random_layer_draws_from_its_generator(name):
    """The same seed draws the same twice, another seed draws anew, and
    ``dropout_generators`` registers the layer's CUDA generator with a
    captured program (a stand-in here: the CPU has no CUDA generator)."""
    build, make = RANDOM_LAYERS[name]
    g = torch.Generator()
    m = build(g)
    outs = []
    for seed in (5, 5, 6):
        g.manual_seed(seed)
        outs.append(m(make()))
    assert torch.equal(outs[0], outs[1])
    assert not torch.equal(outs[0], outs[2])

    class CudaGenerator:
        device = torch.device("cuda")

    m.generator = CudaGenerator()
    model = nn.Sequential().add(nn.Linear(9, 9)).add(m)
    assert dropout_generators(model) == [m.generator]


# ----------------------------------------------------- fp32 islands, bf16
@pytest.mark.parametrize("name", ["SoftMax", "SoftMin"])
def test_softmax_islands_return_fp32_on_bf16_input(name):
    x = _x(B, 3, 7)
    want = getattr(jnn, name)().apply({}, {}, jnp.asarray(x, jnp.bfloat16))[0]
    got = getattr(nn, name)()(torch.from_numpy(x).bfloat16())
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


# ------------------------------------------------------ activity penalties
@pytest.mark.parametrize("name,build,x", [
    ("ActivityRegularization",
     lambda p: p.ActivityRegularization(0.1, 0.2), _x(B, 5)),
    ("NegativeEntropyPenalty", lambda p: p.NegativeEntropyPenalty(0.3),
     _pos(B, 5)),
])
def test_penalty_matches_jax_state(name, build, x):
    jm, tm = build(jnn), build(nn)

    def jpen(xx):
        return jm.apply({}, jm.get_state(), xx, training=True)[1]["penalty"]

    want, gx = jax.value_and_grad(jpen)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out, state = tm.run(xt, {})
    assert out is xt and set(state) == {"penalty"}
    np.testing.assert_allclose(state["penalty"].item(), float(want),
                               rtol=1e-6)
    (g,) = torch.autograd.grad(state["penalty"], xt)
    assert _rel(g.numpy(), gx) <= 1e-5


def test_penalty_enters_the_training_loss_like_jax():
    """One Adam step of Linear -> ActivityRegularization -> Linear with
    MSE: the loss (the penalty included at full strength) and the updated
    parameters equal JAX's trainer's."""
    def build(pkg):
        return (pkg.Sequential().add(pkg.Linear(5, 4))
                .add(pkg.ActivityRegularization(0.05, 0.1))
                .add(pkg.Linear(4, 3)))

    JaxRNG.set_seed(7)
    jm = build(jnn)
    tm = build(nn)
    load_jax_params(tm, jax.device_get(jm.get_params()))
    x, y = _x(4, 5, seed=1), _x(4, 3, seed=2)
    jopt = joptim.LocalOptimizer(jm, JDataSet.array([]), jnn.MSECriterion())
    jopt.set_optim_method(joptim.Adam(learningrate=0.01))
    step = jax.jit(jopt._make_step_fn())
    params, _, _, jloss = step(
        jm.get_params(), jm.get_state(),
        jopt.optim_method.init_state(jm.get_params()),
        jnp.asarray(0, jnp.int32), jnp.asarray(x), jnp.asarray(y),
        jax.random.PRNGKey(0))
    topt = (toptim.LocalOptimizer(tm, DataSet.array([]), nn.MSECriterion(),
                                  device="cpu")
            .set_optim_method(toptim.Adam(learningrate=0.01)))
    loss = topt.train_step(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(loss, float(jloss), rtol=1e-5)
    flat = flatten_tree(jax.device_get(params))
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), flat[n], rtol=1e-5,
                                   atol=1e-6)


# ------------------------------------------------------------ MaskedSelect
def test_masked_select_is_eager_and_refused_under_capture(monkeypatch):
    x, mask = _x(3, 4), (_x(3, 4, seed=1) > 0).astype(np.float32)
    want = jnn.MaskedSelect().forward(JT(jnp.asarray(x), jnp.asarray(mask)))
    m = nn.MaskedSelect()
    got = m(T(torch.from_numpy(x), torch.from_numpy(mask)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with pytest.raises(MaskedSelectCaptureError, match="captured program"):
        m(T(torch.from_numpy(x), torch.from_numpy(mask)))


# ------------------------------------------------------------ initializers
@pytest.mark.parametrize("method,shape", [
    ("BilinearFiller", (2, 3, 4, 4)), ("BilinearFiller", (1, 2, 3, 5)),
    ("ConstInitMethod", (3, 4)),
])
def test_initializers_match_jax(method, shape):
    args = (0.375,) if method == "ConstInitMethod" else ()
    want = getattr(jnn, method)(*args).init(shape, 1, 1)
    got = getattr(nn, method)(*args).init(shape, 1, 1)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_cosine_similarity_matches_jax():
    from bigdl_tpu.nn.cosine import cosine_similarity as jcos
    from bigdl_tpu_torch.nn.cosine import cosine_similarity
    a, b = _x(4, 6), _x(4, 6, seed=1)
    np.testing.assert_allclose(
        cosine_similarity(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jcos(jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)


# ---------------------------------------------------------- the name diff
TAIL_FILES = ("activation", "criterion", "misc", "containers",
              "normalization", "shape_ops", "convolution", "tf_utils",
              "volumetric", "cosine", "initialization", "pooling",
              "quantized", "detection", "multibox", "roi", "maskrcnn")


def _defined(path) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    return {n.name for n in tree.body
            if isinstance(n, (ast.ClassDef, ast.FunctionDef))
            and not n.name.startswith("_")}


def test_every_public_definition_of_the_tail_files_is_ported():
    port_dir = os.path.join(ROOT, "bigdl_tpu_torch", "nn")
    port = set().union(*(_defined(os.path.join(port_dir, f))
                         for f in os.listdir(port_dir) if f.endswith(".py")))
    # detection's pairwise_iou is defined beside the NMS kernels that
    # compute it (nn.detection imports it from there)
    port |= _defined(os.path.join(ROOT, "bigdl_tpu_torch", "kernels",
                                  "nms.py"))
    missing = {f: sorted(_defined(os.path.join(
        ROOT, "bigdl_tpu", "nn", f + ".py")) - port) for f in TAIL_FILES}
    assert {f: m for f, m in missing.items() if m} == {}
    exported = set(nn.__all__)
    jexported = {n for n in dir(jnn) if not n.startswith("_")}
    tail = set().union(*(_defined(os.path.join(
        ROOT, "bigdl_tpu", "nn", f + ".py")) for f in TAIL_FILES))
    assert sorted((tail & jexported) - exported) == []
