"""Inception-v1 (GoogLeNet) and Inception-v2 (BN-Inception).

Counterpart of ``bigdl_tpu/models/inception/inception.py``, with its
``set_name`` names, so one params dict moves between the packages by path
(``convert.load_jax_params``): ``Inception_Layer_v1(inputSize,
[[c1], [r3, c3], [r5, c5], [pp]], prefix)`` builds a ``Concat`` of four
branches (1x1 | 1x1→3x3 | 1x1→5x5 | maxpool→1x1);
``Inception_v1_NoAuxClassifier`` is the plain Sequential stack;
``Inception_v1`` adds the two auxiliary classifier heads after inception 4a
and 4d and outputs a 3-element Table (a ``Graph`` with three outputs),
trained with ``ParallelCriterion`` (main loss weight 1.0, aux 0.3). The v2
family puts batch norm after every convolution. BASELINE.md config 3.

Weights are drawn on the CPU from ``generator`` and the model is moved to
``device`` (default the card); ``dropout_generator`` is the dropout layers'
generator (``nn.Dropout``). Convolutions run on cuDNN (``F.conv2d``), the
``Concat`` joins as ``torch.cat`` along the channel axis of the layout.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.utils.device import resolve_device
from bigdl_tpu_torch.utils.table import Table


def _cfg(v):
    return list(v.values()) if isinstance(v, Table) else list(v)


def _conv(n_in, n_out, kw, kh, sw=1, sh=1, pw=0, ph=0, *, name, g,
          with_bias=True):
    return nn.SpatialConvolution(n_in, n_out, kw, kh, sw, sh, pw, ph,
                                 with_bias=with_bias,
                                 generator=g).set_name(name)


def Inception_Layer_v1(input_size: int, config, name_prefix: str = "", *,
                       generator: Optional[torch.Generator] = None
                       ) -> nn.Concat:
    """The 4-branch inception block."""
    g = generator
    cfg = _cfg(config)
    c1 = _cfg(cfg[0])[0]
    r3, c3 = _cfg(cfg[1])
    r5, c5 = _cfg(cfg[2])
    pp = _cfg(cfg[3])[0]
    concat = nn.Concat(2)
    concat.add(nn.Sequential()
               .add(_conv(input_size, c1, 1, 1, name=name_prefix + "1x1", g=g))
               .add(nn.ReLU()))
    concat.add(nn.Sequential()
               .add(_conv(input_size, r3, 1, 1,
                          name=name_prefix + "3x3_reduce", g=g))
               .add(nn.ReLU())
               .add(_conv(r3, c3, 3, 3, 1, 1, 1, 1, name=name_prefix + "3x3",
                          g=g))
               .add(nn.ReLU()))
    concat.add(nn.Sequential()
               .add(_conv(input_size, r5, 1, 1,
                          name=name_prefix + "5x5_reduce", g=g))
               .add(nn.ReLU())
               .add(_conv(r5, c5, 5, 5, 1, 1, 2, 2, name=name_prefix + "5x5",
                          g=g))
               .add(nn.ReLU()))
    concat.add(nn.Sequential()
               .add(nn.SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil())
               .add(_conv(input_size, pp, 1, 1,
                          name=name_prefix + "pool_proj", g=g))
               .add(nn.ReLU()))
    return concat


def _stem(g) -> nn.Sequential:
    def block(n_in, cfg, prefix):
        return Inception_Layer_v1(n_in, cfg, prefix, generator=g)

    return (nn.Sequential()
            .add(_conv(3, 64, 7, 7, 2, 2, 3, 3, name="conv1/7x7_s2", g=g))
            .add(nn.ReLU())
            .add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
            .add(nn.SpatialCrossMapLRN(5, 0.0001, 0.75))
            .add(_conv(64, 64, 1, 1, name="conv2/3x3_reduce", g=g))
            .add(nn.ReLU())
            .add(_conv(64, 192, 3, 3, 1, 1, 1, 1, name="conv2/3x3", g=g))
            .add(nn.ReLU())
            .add(nn.SpatialCrossMapLRN(5, 0.0001, 0.75))
            .add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
            .add(block(192, [[64], [96, 128], [16, 32], [32]],
                       "inception_3a/"))
            .add(block(256, [[128], [128, 192], [32, 96], [64]],
                       "inception_3b/"))
            .add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
            .add(block(480, [[192], [96, 208], [16, 48], [64]],
                       "inception_4a/")))


def _mid(g) -> nn.Sequential:
    def block(n_in, cfg, prefix):
        return Inception_Layer_v1(n_in, cfg, prefix, generator=g)

    return (nn.Sequential()
            .add(block(512, [[160], [112, 224], [24, 64], [64]],
                       "inception_4b/"))
            .add(block(512, [[128], [128, 256], [24, 64], [64]],
                       "inception_4c/"))
            .add(block(512, [[112], [144, 288], [32, 64], [64]],
                       "inception_4d/")))


def _tail(class_num: int, has_dropout: bool, g, dropout_generator
          ) -> nn.Sequential:
    def block(n_in, cfg, prefix):
        return Inception_Layer_v1(n_in, cfg, prefix, generator=g)

    seq = (nn.Sequential()
           .add(block(528, [[256], [160, 320], [32, 128], [128]],
                      "inception_4e/"))
           .add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
           .add(block(832, [[256], [160, 320], [32, 128], [128]],
                      "inception_5a/"))
           .add(block(832, [[384], [192, 384], [48, 128], [128]],
                      "inception_5b/"))
           .add(nn.SpatialAveragePooling(7, 7, 1, 1)))
    if has_dropout:
        seq.add(nn.Dropout(0.4, generator=dropout_generator))
    return (seq
            .add(nn.View([1024]))
            .add(nn.Linear(1024, class_num, generator=g)
                 .set_name("loss3/classifier"))
            .add(nn.LogSoftMax()))


def _aux_head(n_in: int, class_num: int, prefix: str, g,
              use_bn: bool = False) -> nn.Sequential:
    """Aux classifier head; ``use_bn`` swaps the conv+ReLU for conv+BN+ReLU
    (the v2 variant)."""
    seq = nn.Sequential().add(nn.SpatialAveragePooling(5, 5, 3, 3).ceil())
    if use_bn:
        seq.add(_conv_bn(n_in, 128, 1, 1, name=prefix + "conv", g=g))
    else:
        seq.add(_conv(n_in, 128, 1, 1, name=prefix + "conv", g=g))
        seq.add(nn.ReLU())
    return (seq
            .add(nn.View([128 * 4 * 4]))
            .add(nn.Linear(128 * 4 * 4, 1024, generator=g)
                 .set_name(prefix + "fc"))
            .add(nn.ReLU())
            .add(nn.Linear(1024, class_num, generator=g)
                 .set_name(prefix + "classifier"))
            .add(nn.LogSoftMax()))


def _flatten(*blocks: nn.Sequential) -> nn.Sequential:
    model = nn.Sequential()
    for block in blocks:
        for m in block.children():
            model.add(m)
    return model


def Inception_v1_NoAuxClassifier(
        class_num: int = 1000, has_dropout: bool = True, *,
        generator: Optional[torch.Generator] = None,
        dropout_generator: Optional[torch.Generator] = None,
        device=None) -> nn.Sequential:
    g = generator
    return _flatten(_stem(g), _mid(g), _tail(
        class_num, has_dropout, g, dropout_generator)).to(
        resolve_device(device))


def Inception_v1(class_num: int = 1000, has_dropout: bool = True, *,
                 generator: Optional[torch.Generator] = None,
                 dropout_generator: Optional[torch.Generator] = None,
                 device=None) -> nn.Graph:
    """Full GoogLeNet with the two aux heads; outputs T(main, aux1, aux2)."""
    g = generator
    inp = nn.Input()
    feat4a = _stem(g).inputs(inp)
    aux1 = _aux_head(512, class_num, "loss1/", g).inputs(feat4a)
    feat4d = _mid(g).inputs(feat4a)
    aux2 = _aux_head(528, class_num, "loss2/", g).inputs(feat4d)
    main = _tail(class_num, has_dropout, g, dropout_generator).inputs(feat4d)
    return nn.Graph(inp, [main, aux1, aux2]).to(resolve_device(device))


# --------------------------------------------------------------------- v2
def _conv_bn(in_p: int, out_p: int, kw: int, kh: int, sw: int = 1,
             sh: int = 1, pw: int = 0, ph: int = 0, *, name: str = "",
             g=None) -> nn.Sequential:
    """conv (no bias) + BN + ReLU — the BN-Inception building block."""
    return (nn.Sequential()
            .add(_conv(in_p, out_p, kw, kh, sw, sh, pw, ph, name=name, g=g,
                       with_bias=False))
            .add(nn.SpatialBatchNormalization(out_p, generator=g)
                 .set_name(name + "/bn"))
            .add(nn.ReLU()))


def Inception_Layer_v2(input_size: int, config, name_prefix: str = "", *,
                       generator: Optional[torch.Generator] = None
                       ) -> nn.Concat:
    """The BN-Inception block: branches 1x1 | 1x1→3x3 | 1x1→3x3→3x3 |
    pool(+proj), every conv followed by BatchNorm. ``config`` =
    [[c1], [r3, c3], [rd, cd], [pool_kind, pp]]; c1 == 0 marks a stride-2
    reduction block (no 1x1 branch, pass-through pool, stride on the
    3x3s)."""
    g = generator
    cfg = _cfg(config)
    c1 = _cfg(cfg[0])[0]
    r3, c3 = _cfg(cfg[1])
    rd, cd = _cfg(cfg[2])
    pool_kind, pp = _cfg(cfg[3])
    reduction = c1 == 0
    stride = 2 if reduction else 1

    concat = nn.Concat(2)
    if not reduction:
        concat.add(_conv_bn(input_size, c1, 1, 1, name=name_prefix + "1x1",
                            g=g))
    concat.add(nn.Sequential()
               .add(_conv_bn(input_size, r3, 1, 1,
                             name=name_prefix + "3x3_reduce", g=g))
               .add(_conv_bn(r3, c3, 3, 3, stride, stride, 1, 1,
                             name=name_prefix + "3x3", g=g)))
    concat.add(nn.Sequential()
               .add(_conv_bn(input_size, rd, 1, 1,
                             name=name_prefix + "double3x3_reduce", g=g))
               .add(_conv_bn(rd, cd, 3, 3, 1, 1, 1, 1,
                             name=name_prefix + "double3x3a", g=g))
               .add(_conv_bn(cd, cd, 3, 3, stride, stride, 1, 1,
                             name=name_prefix + "double3x3b", g=g)))
    pool_seq = nn.Sequential()
    if pool_kind == "max" or reduction:
        pool_seq.add(nn.SpatialMaxPooling(3, 3, stride, stride,
                                          0 if reduction else 1,
                                          0 if reduction else 1).ceil())
    else:
        pool_seq.add(nn.SpatialAveragePooling(3, 3, stride, stride, 1, 1)
                     .ceil())
    if pp > 0:
        pool_seq.add(_conv_bn(input_size, pp, 1, 1,
                              name=name_prefix + "pool_proj", g=g))
    concat.add(pool_seq)
    return concat


def _v2_stem(g) -> nn.Sequential:
    def block(n_in, cfg, prefix):
        return Inception_Layer_v2(n_in, cfg, prefix, generator=g)

    return (nn.Sequential()
            .add(_conv_bn(3, 64, 7, 7, 2, 2, 3, 3, name="conv1/7x7_s2", g=g))
            .add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
            .add(_conv_bn(64, 64, 1, 1, name="conv2/3x3_reduce", g=g))
            .add(_conv_bn(64, 192, 3, 3, 1, 1, 1, 1, name="conv2/3x3", g=g))
            .add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
            .add(block(192, [[64], [64, 64], [64, 96], ["avg", 32]],
                       "inception_3a/"))
            .add(block(256, [[64], [64, 96], [64, 96], ["avg", 64]],
                       "inception_3b/"))
            .add(block(320, [[0], [128, 160], [64, 96], ["max", 0]],
                       "inception_3c/"))
            .add(block(576, [[224], [64, 96], [96, 128], ["avg", 128]],
                       "inception_4a/")))


def _v2_mid(g) -> nn.Sequential:
    def block(n_in, cfg, prefix):
        return Inception_Layer_v2(n_in, cfg, prefix, generator=g)

    return (nn.Sequential()
            .add(block(576, [[192], [96, 128], [96, 128], ["avg", 128]],
                       "inception_4b/"))
            .add(block(576, [[160], [128, 160], [128, 160], ["avg", 96]],
                       "inception_4c/"))
            .add(block(576, [[96], [128, 192], [160, 192], ["avg", 96]],
                       "inception_4d/")))


def _v2_tail(class_num: int, g) -> nn.Sequential:
    def block(n_in, cfg, prefix):
        return Inception_Layer_v2(n_in, cfg, prefix, generator=g)

    return (nn.Sequential()
            .add(block(576, [[0], [128, 192], [192, 256], ["max", 0]],
                       "inception_4e/"))
            .add(block(1024, [[352], [192, 320], [160, 224], ["avg", 128]],
                       "inception_5a/"))
            .add(block(1024, [[352], [192, 320], [192, 224], ["max", 128]],
                       "inception_5b/"))
            .add(nn.SpatialAveragePooling(7, 7, 1, 1))
            .add(nn.View([1024]))
            .add(nn.Linear(1024, class_num, generator=g)
                 .set_name("loss3/classifier"))
            .add(nn.LogSoftMax()))


def Inception_v2_NoAuxClassifier(
        class_num: int = 1000, *,
        generator: Optional[torch.Generator] = None,
        device=None) -> nn.Sequential:
    g = generator
    return _flatten(_v2_stem(g), _v2_mid(g), _v2_tail(class_num, g)).to(
        resolve_device(device))


def Inception_v2(class_num: int = 1000, *,
                 generator: Optional[torch.Generator] = None,
                 device=None) -> nn.Graph:
    """BN-Inception with two aux heads (after 4a and 4d, mirroring the v1
    head placement); outputs T(main, aux1, aux2) for ParallelCriterion."""
    g = generator
    inp = nn.Input()
    feat4a = _v2_stem(g).inputs(inp)
    aux1 = _aux_head(576, class_num, "loss1/", g, use_bn=True).inputs(feat4a)
    feat4d = _v2_mid(g).inputs(feat4a)
    aux2 = _aux_head(576, class_num, "loss2/", g, use_bn=True).inputs(feat4d)
    main = _v2_tail(class_num, g).inputs(feat4d)
    return nn.Graph(inp, [main, aux1, aux2]).to(resolve_device(device))
