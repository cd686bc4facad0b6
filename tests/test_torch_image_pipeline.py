"""The folder-backed image pipeline of the port against the JAX package's.

- every vision transformer (``transform/vision/image.py``) against JAX's on
  one seed: the same arrays from the shared stream and the same per-sample
  draws under ``sample_index_scope``; ``Resize`` and ``AspectScale`` bitwise
  JAX's (PIL) on up- and down-scales, the pipeline's 280→256 and
  500×375→256 among them; the classic ``BGRImg*`` names;
- ``ImageFolderDataSet`` on one folder of PNG, JPEG and BMP files: the
  items, labels (``one_based`` too), the seeded shuffle order and the
  decoded arrays; ``distributed=True`` refused naming A.6; a file the codec
  refuses treated as any unreadable file (``BIGDL_BAD_SAMPLE_POLICY``);
- ``imagenet_sets``: the same train and validation MiniBatches bitwise, on
  a folder and on the synthetic fallback;
- the formats: ``.bdlrec`` image records and the decoded-sample cache of an
  image folder byte-identical across the packages, and read across;
- the CIFAR-10 (python and binary batches) and MNIST (idx, gzipped or not)
  readers on files the test writes;
- the mains with ``--folder`` and ``--device cpu`` against JAX's mains on
  the same files, both starting from JAX's weights carried across in a
  ``save_module`` file, with dropout off: LeNet through ``converge`` on
  idx files (four steps; the verdict's keys too), VGG on CIFAR-10 batches,
  ResNet-18 on an ImageNet folder and Inception-v1 on a folder (one step
  each); the losses agree to 1e-4 relative. The LeNet main resumed from a
  module and an optim method that the same test saved.
"""

from __future__ import annotations

import gzip
import math
import os
import pickle
import struct

import numpy as np
import pytest
import torch
from PIL import Image

from bigdl_tpu.dataset import image as jimage
from bigdl_tpu.dataset import cifar as jcifar
from bigdl_tpu.dataset import mnist as jmnist
from bigdl_tpu.dataset import recordio as jrecordio
from bigdl_tpu.dataset.image_folder import ImageFolderDataSet as JFolder
from bigdl_tpu.dataset.transformer import sample_index_scope as jscope
from bigdl_tpu.models.imagenet_data import imagenet_sets as jimagenet_sets
from bigdl_tpu.transform.vision import image as jv
from bigdl_tpu.utils.engine import Engine as JEngine
from bigdl_tpu.utils.random_generator import RandomGenerator as JRNG
from bigdl_tpu_torch.dataset import cifar, mnist, recordio
from bigdl_tpu_torch.dataset import image as timage
from bigdl_tpu_torch.dataset.dataset import DataSet
from bigdl_tpu_torch.dataset.image_folder import (
    ImageFolderDataSet, write_synthetic_image_folder,
)
from bigdl_tpu_torch.dataset.transformer import sample_index_scope
from bigdl_tpu_torch.models.imagenet_data import imagenet_sets
from bigdl_tpu_torch.transform.vision import image as tv
from bigdl_tpu_torch.utils.engine import Engine
from bigdl_tpu_torch.utils.random_generator import RandomGenerator


@pytest.fixture(autouse=True)
def _one_thread_and_fresh_port_engine():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    Engine.reset()
    RandomGenerator.set_seed(1)


def seed_both(seed: int) -> None:
    """JAX's and the port's Engine seed and RandomGenerator (salts too)."""
    JEngine.init(seed=seed)
    Engine.init(seed=seed)
    JRNG.set_seed(seed)
    RandomGenerator.set_seed(seed)


def images(n=6, shape=(20, 26, 3), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, shape, dtype=np.uint8) for _ in range(n)]


EIG = dict(alphastd=0.1, eigval=[0.2175, 0.0188, 0.0045],
           eigvec=[[-0.5675, 0.7192, 0.4009], [-0.5808, -0.0045, -0.8140],
                   [-0.5836, -0.6948, 0.4203]])

TRANSFORMERS = {
    "Resize": lambda m: m.Resize(13, 37),
    "AspectScale": lambda m: m.AspectScale(16, max_size=30),
    "CenterCrop": lambda m: m.CenterCrop(9, 11),
    "RandomCrop": lambda m: m.RandomCrop(9, 11),
    "HFlip": lambda m: m.HFlip(),
    "RandomHFlip": lambda m: m.RandomHFlip(),
    "ChannelNormalize": lambda m: m.ChannelNormalize((120, 110, 100),
                                                     (50, 60, 70)),
    "PixelBytesToMat": lambda m: m.PixelBytesToMat(),
    "Brightness": lambda m: m.Brightness(-20, 30),
    "Contrast": lambda m: m.Contrast(0.5, 1.5),
    "Saturation": lambda m: m.Saturation(0.4, 1.6),
    "ColorJitter": lambda m: m.ColorJitter(),
    "Lighting": lambda m: m.Lighting(**EIG),
    "Expand": lambda m: m.Expand(2.5),
    "ChannelOrder": lambda m: m.ChannelOrder(),
    "RandomTransformer": lambda m: m.RandomTransformer(m.HFlip(), 0.5),
    "MatToTensor": lambda m: m.MatToTensor(),
    "chain": lambda m: (m.AspectScale(24) >> m.RandomCrop(16, 16)
                        >> m.RandomHFlip() >> m.ColorJitter()
                        >> m.Lighting(**EIG) >> m.MatToTensor()),
}


def _apply(m, t, img):
    """``t`` on one ImageFeature of module ``m`` (jv or tv)."""
    return np.asarray(t.element_fn()(m.ImageFeature(img.copy(), 3)).image)


@pytest.mark.parametrize("name", sorted(TRANSFORMERS))
def test_transformer_matches_jax_on_one_seed(name):
    seed_both(11)
    jt, tt = TRANSFORMERS[name](jv), TRANSFORMERS[name](tv)
    imgs = images()
    for img in imgs:                       # the shared sequential stream
        np.testing.assert_array_equal(_apply(tv, tt, img),
                                      _apply(jv, jt, img))
    for i, img in reversed(list(enumerate(imgs))):   # per-sample draws
        with jscope(i):
            want = _apply(jv, jt, img)
        with sample_index_scope(i):
            got = _apply(tv, tt, img)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape,size", [
    ((280, 280, 3), (256, 256)), ((375, 500, 3), (256, 341)),
    ((20, 26, 3), (64, 80)), ((33, 17, 3), (8, 5)),
])
def test_resize_is_jax_pil_resize_bitwise(shape, size):
    img = images(1, shape)[0]
    want = jv.Resize(*size).transform_feature(jv.ImageFeature(img)).image
    got = tv.Resize(*size).transform_feature(tv.ImageFeature(img)).image
    np.testing.assert_array_equal(got, want)
    # a float image is cast to uint8, resized and cast back, as in JAX
    f = img.astype(np.float32) * 1.3
    want = jv.Resize(*size).transform_feature(jv.ImageFeature(f)).image
    got = tv.Resize(*size).transform_feature(tv.ImageFeature(f)).image
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    want = jv.AspectScale(256).transform_feature(jv.ImageFeature(img)).image
    got = tv.AspectScale(256).transform_feature(tv.ImageFeature(img)).image
    np.testing.assert_array_equal(got, want)


def test_classic_names_and_frame_to_sample_match_jax():
    seed_both(5)
    img = images(1)[0].astype(np.float32)
    for jt, tt in ((jimage.BGRImgNormalizer(100, 110, 120, 50, 60, 70),
                    timage.BGRImgNormalizer(100, 110, 120, 50, 60, 70)),
                   (jimage.BGRImgCropper(8, 6), timage.BGRImgCropper(8, 6)),
                   (jimage.BGRImgRdmCropper(8, 6),
                    timage.BGRImgRdmCropper(8, 6))):
        np.testing.assert_array_equal(_apply(tv, tt, img),
                                      _apply(jv, jt, img))
    js = list(jimage.BGRImgToSample()(iter([jv.ImageFeature(img, 4)])))[0]
    ts = list(timage.BGRImgToSample()(iter([tv.ImageFeature(img, 4)])))[0]
    np.testing.assert_array_equal(ts.feature[0], js.feature[0])
    np.testing.assert_array_equal(ts.label[0], js.label[0])
    frame = tv.Pipeline(tv.CenterCrop(8, 8), tv.MatToTensor())(
        tv.ImageFrame.from_arrays(images(3), [0, 1, 2]))
    jframe = jv.Pipeline(jv.CenterCrop(8, 8), jv.MatToTensor())(
        jv.ImageFrame.from_arrays(images(3), [0, 1, 2]))
    for a, b in zip(frame, jframe):
        np.testing.assert_array_equal(a.feature[0], b.feature[0])


# ---------------------------------------------------------------- folders
def _folder(root, n_classes=3, per=3, size=(30, 40)):
    """PNG (the port's writer), JPEG and BMP (PIL) files in class dirs."""
    rng = np.random.default_rng(2)
    for c in range(n_classes):
        d = os.path.join(root, f"c{c}")
        os.makedirs(d)
        for i in range(per):
            arr = rng.integers(0, 256, size + (3,), dtype=np.uint8)
            kind = (c + i) % 3
            name = os.path.join(d, f"im{i}." + ("png", "jpg", "bmp")[kind])
            if kind == 0:
                from bigdl_tpu_torch.transform.vision.codec import write_png
                write_png(name, arr)
            else:
                Image.fromarray(arr).save(name)
        with open(os.path.join(d, "notes.txt"), "w") as f:
            f.write("not an image")
    return str(root)


def test_image_folder_matches_jax(tmp_path):
    root = _folder(tmp_path / "f")
    for one_based in (False, True):
        ours = ImageFolderDataSet(root, num_workers=2, one_based=one_based)
        theirs = JFolder(root, num_workers=2, one_based=one_based)
        assert ours._items == theirs._items
        assert ours.classes == theirs.classes
        assert ours.class_to_label == theirs.class_to_label
        RandomGenerator.set_seed(7)
        JRNG.set_seed(7)
        ours.shuffle()
        theirs.shuffle()
        np.testing.assert_array_equal(ours._order, theirs._order)
        for a, b in zip(ours.data(train=True), theirs.data(train=True)):
            np.testing.assert_array_equal(a.image, b.image)
            assert (a.label, a["uri"]) == (b.label, b["uri"])
        ours.close()
        theirs.close()
    from bigdl_tpu_torch.dataset.dataset import is_distributed
    assert is_distributed(ImageFolderDataSet(root, distributed=True))


def test_image_folder_treats_refused_files_as_unreadable(tmp_path,
                                                         monkeypatch):
    """A progressive JPEG (refused by the codec, decoded by PIL) goes the
    way of any unreadable file: it raises under the default policy and
    is dropped under ``BIGDL_BAD_SAMPLE_POLICY=skip``."""
    from bigdl_tpu_torch.transform.vision.codec import UnsupportedImageError
    root = _folder(tmp_path / "f", n_classes=1, per=3)
    Image.fromarray(images(1)[0]).save(
        os.path.join(root, "c0", "zz_progressive.jpg"), progressive=True)
    ds = ImageFolderDataSet(root, num_workers=2)
    with pytest.raises(UnsupportedImageError, match="progressive"):
        list(ds.data(train=False))
    monkeypatch.setenv("BIGDL_BAD_SAMPLE_POLICY", "skip")
    got = [f["uri"] for f in ds.data(train=False)]
    assert len(got) == 3 and not any("progressive" in u for u in got)
    ds.close()


def _batches(ds, n):
    out = []
    for b in ds.data(train=True):
        out.append((np.asarray(b.input), np.asarray(b.target)))
        if len(out) == n:
            break
    return out


@pytest.mark.parametrize("on_folder", [True, False])
def test_imagenet_sets_give_jax_minibatches(tmp_path, on_folder):
    folder = None
    if on_folder:
        folder = write_synthetic_image_folder(str(tmp_path / "in"),
                                              n_classes=3, n_per_class=4,
                                              size=40, seed=3)
    seed_both(21)
    jtrain, jval = jimagenet_sets(folder, 4, crop=32, num_workers=2,
                                  synthetic_classes=2, synthetic_per_class=4)
    ttrain, tval = imagenet_sets(folder, 4, crop=32, num_workers=2,
                                 synthetic_classes=2, synthetic_per_class=4)
    for ours, theirs in ((ttrain, jtrain), (tval, jval)):
        got, want = _batches(ours, 2), _batches(theirs, 2)
        assert len(got) == len(want) == 2
        for (x, y), (jx, jy) in zip(got, want):
            assert x.shape == (4, 3, 32, 32)
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)


def test_image_records_and_cache_are_byte_identical(tmp_path):
    root = _folder(tmp_path / "f", n_classes=2, per=3)
    ours = recordio.write_image_records(root, str(tmp_path / "t.bdlrec"), 2)
    theirs = jrecordio.write_image_records(root, str(tmp_path / "j.bdlrec"),
                                           2)
    for a, b in zip(ours, theirs):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    # the image decoder is the default; the records decode to JAX's arrays
    got = list(DataSet.record_files(theirs, num_workers=2).data(train=False))
    want = list(jrecordio.RecordFileDataSet(
        ours, jrecordio.image_record_decoder, num_workers=2).data(train=False))
    assert len(got) == len(want) == 6
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.image, b.image)
        assert a.label == b.label
    # the decoded-sample cache of an image folder, one epoch each
    for cls, name in ((ImageFolderDataSet, "t"), (JFolder, "j")):
        ds = cls(root, num_workers=2, cache=True,
                 cache_dir=str(tmp_path / f"cache_{name}"))
        first = [f.image for f in ds.data(train=False)]
        again = [f.image for f in ds.data(train=False)]
        for a, b in zip(first, again):
            np.testing.assert_array_equal(a, b)
        ds.close()
    tfiles = sorted(os.listdir(tmp_path / "cache_t"))
    assert tfiles == sorted(os.listdir(tmp_path / "cache_j")) and tfiles
    for n in tfiles:
        assert (tmp_path / "cache_t" / n).read_bytes() == \
            (tmp_path / "cache_j" / n).read_bytes(), n


# ----------------------------------------------------------- CIFAR, MNIST
def _cifar_python(root, n=6):
    rng = np.random.default_rng(4)
    d = os.path.join(root, "cifar-10-batches-py")
    os.makedirs(d)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(os.path.join(d, name), "wb") as f:
            pickle.dump({b"data": rng.integers(0, 256, (n, 3072),
                                               dtype=np.uint8),
                         b"labels": list(rng.integers(0, 10, n))}, f)
    return str(root)


def _cifar_binary(root, n=6):
    rng = np.random.default_rng(5)
    os.makedirs(root, exist_ok=True)
    for name in [f"data_batch_{i}.bin" for i in range(1, 6)] \
            + ["test_batch.bin"]:
        raw = rng.integers(0, 256, (n, 3073), dtype=np.uint8)
        raw[:, 0] %= 10
        raw.tofile(os.path.join(root, name))
    return str(root)


def _idx(path, arr):
    body = struct.pack(">I", 0x800 | arr.ndim) + struct.pack(
        ">" + "I" * arr.ndim, *arr.shape) + arr.astype(np.uint8).tobytes()
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "wb") as f:
        f.write(body)


def _mnist(root, n_train=64, n_test=32, gz=False):
    rng = np.random.default_rng(6)
    os.makedirs(root, exist_ok=True)
    ext = ".gz" if gz else ""
    for split, n in (("train", n_train), ("t10k", n_test)):
        protos = rng.integers(0, 256, (10, 28, 28))
        labels = rng.integers(0, 10, n)
        _idx(os.path.join(root, f"{split}-images-idx3-ubyte{ext}"),
             np.clip(protos[labels] + rng.integers(-30, 30, (n, 28, 28)),
                     0, 255))
        _idx(os.path.join(root, f"{split}-labels-idx1-ubyte{ext}"), labels)
    return str(root)


def test_cifar_and_mnist_readers_return_jax_arrays(tmp_path):
    for folder in (_cifar_python(tmp_path / "py"),
                   _cifar_binary(tmp_path / "bin")):
        for split in ("train", "test"):
            x, y = cifar.load_cifar10(folder, split)
            jx, jy = jcifar.load_cifar10(folder, split)
            assert x.dtype == jx.dtype and y.dtype == jy.dtype
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)
    for gz in (False, True):
        folder = _mnist(tmp_path / f"mnist{gz}", gz=gz)
        for split in ("train", "test"):
            x, y = mnist.load_mnist(folder, split)
            jx, jy = jmnist.load_mnist(folder, split)
            assert x.shape == (64 if split == "train" else 32, 28, 28)
            np.testing.assert_array_equal(x, jx)
            np.testing.assert_array_equal(y, jy)
    with pytest.raises(FileNotFoundError, match="no CIFAR-10 batches"):
        cifar.load_cifar10(str(tmp_path / "mnistFalse"))


# ------------------------------------------------------------------ mains
def _walk_jax(m):
    yield m
    for _, child in (m.named_children() if hasattr(m, "named_children")
                     else ()):
        yield from _walk_jax(child)


def _dropout_off(jmodel, tmodel) -> None:
    """Dropout off in both models: each package draws its masks from its
    own generator, so a step with dropout on cannot agree across them."""
    from bigdl_tpu.nn import Dropout as JDropout
    from bigdl_tpu_torch.nn import Dropout

    jdrops = [m for m in _walk_jax(jmodel) if isinstance(m, JDropout)]
    drops = [m for m in tmodel.modules() if isinstance(m, Dropout)]
    assert len(jdrops) == len(drops)
    for m in jdrops + drops:
        m.set_p(0.0)


def _record_optimizers(monkeypatch, optim_module) -> list:
    """Every ``LocalOptimizer`` a main builds (JAX's mains and ``converge``
    return the model, not the optimizer that holds ``state["loss"]``)."""
    made = []

    class Recording(optim_module.LocalOptimizer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(optim_module, "LocalOptimizer", Recording)
    return made


def _same_weights(jpkg, tpkg, name, args, tmp_path, monkeypatch):
    """Build JAX's model ``name(*args)``, carry it to the port through a
    module file that JAX's ``save_module`` wrote, and make both packages'
    constructor of that name return these two models, so that both mains
    train from the same weights. The models are built before the mains
    run: JAX's constructors (and its module reader) draw from the global
    ``RandomGenerator``, the port's do not, and a draw inside one main only
    would change that main's shuffle."""
    from bigdl_tpu_torch.nn.abstractnn import AbstractModule

    seed_both(0)
    jmodel = getattr(jpkg, name)(*args)
    path = str(tmp_path / f"{name}.bdlm")
    jmodel.save_module(path)
    tmodel = AbstractModule.load(path, "cpu")
    _dropout_off(jmodel, tmodel)
    monkeypatch.setattr(jpkg, name, lambda *a, **k: jmodel)
    monkeypatch.setattr(tpkg, name, lambda *a, **k: tmodel)
    return jmodel, tmodel


def test_lenet_main_and_convergence_on_idx_files_match_jax(
        tmp_path, capsys, monkeypatch):
    """Both packages' ``converge lenet`` on the same idx files, the two
    LeNet-5 mains starting from the same weights (``_same_weights``): the
    four steps of the epoch, shuffled alike, end on the same loss, 1e-4
    relative, and the verdicts have the same keys."""
    import bigdl_tpu.models.lenet as jlenet
    import bigdl_tpu.optim as joptim
    from bigdl_tpu import convergence as jconv
    from bigdl_tpu_torch import convergence
    from bigdl_tpu_torch import optim as toptim
    from bigdl_tpu_torch.models import lenet

    folder = _mnist(tmp_path / "mnist", n_train=128, n_test=64, gz=True)
    _same_weights(jlenet, lenet, "LeNet5", (10,), tmp_path, monkeypatch)
    jopts = _record_optimizers(monkeypatch, joptim)
    topts = _record_optimizers(monkeypatch, toptim)
    seed_both(0)
    want = jconv.converge("lenet", folder, epochs=1, batch_size=32)
    seed_both(0)
    got = convergence.converge("lenet", folder, epochs=1, batch_size=32,
                               device="cpu")
    (jopt,), (opt,) = jopts, topts
    assert opt.state["neval"] == jopt.state["neval"] == 5   # 4 steps, from 1
    assert math.isfinite(opt.state["loss"])
    assert opt.state["loss"] == pytest.approx(jopt.state["loss"], rel=1e-4)
    assert set(got) == set(want)
    assert (got["synthetic"], got["metric"], got["target"]) == \
        (False, "top1", want["target"])
    assert isinstance(got["achieved"], bool) and 0 <= got["value"] <= 1
    monkeypatch.undo()
    capsys.readouterr()
    assert convergence.main(["lenet", "--epochs", "1", "--batch-size", "32",
                             "--device", "cpu", "--synthetic-size",
                             "64"]) == 0
    import json
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["synthetic"] is True and line["achieved"] is None
    assert set(line) == set(want)


# each main's model, built in the test (``_same_weights``)
_MAIN_MODELS = {
    "vgg": ("VggForCifar10", (10,)),
    "resnet": ("ResNet", (3, {"depth": 18, "dataSet": "ImageNet"})),
    "inception": ("Inception_v1_NoAuxClassifier", (3,)),
}


@pytest.mark.parametrize("main,argv,classes", [
    ("vgg", ["-b", "40", "--folder", "CIFAR"], 10),
    ("resnet", ["--dataset", "ImageNet", "--depth", "18", "--classes", "3",
                "-b", "6", "-f", "IMAGENET"], 3),
    ("inception", ["--no-aux", "--classes", "3", "-b", "2",
                   "--max-iteration", "1", "-f", "IMAGENET"], 3),
])
def test_mains_train_from_folders(main, argv, classes, tmp_path,
                                  monkeypatch):
    """One step of the port's main and of JAX's on the same folder, from
    the same weights (``_same_weights``, dropout off in both).
    ``state["loss"]`` is the step's loss before its update; the two agree
    to 1e-4 relative."""
    import importlib

    import bigdl_tpu.optim as joptim

    mod = importlib.import_module(f"bigdl_tpu_torch.models.{main}.train")
    jmod = importlib.import_module(f"bigdl_tpu.models.{main}.train")
    assert not hasattr(mod, "UNPORTED_FLAGS")
    if "CIFAR" in argv:
        folder = _cifar_binary(str(tmp_path / "c"), n=8)
    else:
        folder = write_synthetic_image_folder(
            str(tmp_path / "i"), n_classes=3, n_per_class=2, size=230,
            seed=1)
    argv = [folder if a in ("CIFAR", "IMAGENET") else a for a in argv]

    jpkg = importlib.import_module(f"bigdl_tpu.models.{main}")
    tpkg = importlib.import_module(f"bigdl_tpu_torch.models.{main}")
    _, tmodel = _same_weights(jpkg, tpkg, *_MAIN_MODELS[main], tmp_path,
                              monkeypatch)
    jopts = _record_optimizers(monkeypatch, joptim)

    seed_both(0)
    jmod.main(argv)
    seed_both(0)
    opt = mod.main(["--device", "cpu", *argv])
    (jopt,) = jopts
    assert opt.model is tmodel
    assert opt.state["neval"] == jopt.state["neval"] == 2   # JAX's, from 1
    loss = opt.state["loss"]
    assert math.isfinite(loss)
    assert loss == pytest.approx(jopt.state["loss"], rel=1e-4)
    if main != "resnet":   # a random ResNet-18 starts far from ln(classes)
        assert abs(loss - math.log(classes)) < 0.5, loss


def test_lenet_main_snapshots_from_files_the_same_run_saved(tmp_path):
    from bigdl_tpu_torch.models.lenet import train as lenet_main
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.utils import file as ufile

    folder = _mnist(tmp_path / "m")
    opt = lenet_main.main(["--device", "cpu", "-f", folder, "-b", "16"])
    opt.model.save_module(str(tmp_path / "lenet.bdlm"))
    ufile.save(SGD(learningrate=0.01), str(tmp_path / "sgd.obj"))
    again = lenet_main.main([
        "--device", "cpu", "-f", folder, "-b", "16",
        "--model-snapshot", str(tmp_path / "lenet.bdlm"),
        "--state-snapshot", str(tmp_path / "sgd.obj")])
    assert math.isfinite(again.state["loss"])
    assert again.state["loss"] < opt.state["loss"] + 0.5
