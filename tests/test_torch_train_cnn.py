"""The port's vision training CLI (singa_tpu_torch.tools.train_cnn) on
the CPU, and the data and metric helpers it runs (utils.data,
utils.metrics) against the JAX package's.

The CLI trains one epoch of the synthetic MNIST set (2,048 images, a
class-dependent bright row in each) and its loss must fall: the mean of
the last 8 steps' losses below that of the first 8.  The helpers are
held exactly: the same batches, datasets and counts."""

import numpy as np
import pytest

from singa_tpu.utils import data as jdata
from singa_tpu.utils import metrics as jmetrics
from singa_tpu_torch.tools import train_cnn
from singa_tpu_torch.utils import data as tdata
from singa_tpu_torch.utils import metrics as tmetrics


@pytest.mark.parametrize("model,lr", [("mlp", "0.05"), ("cnn", "0.01")])
def test_cli_trains_an_epoch_on_the_cpu(model, lr, capsys):
    out = train_cnn.main(["--model", model, "--dataset", "mnist",
                          "--device", "cpu", "--epochs", "1", "--lr", lr,
                          "--log-every", "0"])
    (ep,) = out["epochs"]
    losses = ep["losses"]
    assert len(losses) == out["steps_per_epoch"] == 2048 // 64
    assert np.isfinite(losses).all()
    assert np.mean(losses[-8:]) < np.mean(losses[:8]), losses
    assert ep["test_acc"] > 0.5 and ep["images_per_s"] > 0
    assert out["device"] == "cpu" and not out["eval_captured"]
    printed = capsys.readouterr().out
    assert "test acc" in printed and "imgs/s" in printed


def test_cli_refuses_an_unknown_model():
    with pytest.raises(SystemExit):
        train_cnn.main(["--model", "resnet9000", "--device", "cpu"])


@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_yields_the_reference_batches(drop_last, shuffle):
    x = np.random.RandomState(0).randn(37, 4, 4, 1).astype(np.float32)
    y = np.arange(37, dtype=np.int32)
    kw = dict(batch_size=8, shuffle=shuffle, seed=5, drop_last=drop_last)
    ref = jdata.DataLoader(x, y, use_native=False, **kw)
    port = tdata.DataLoader(x, y, **kw)
    assert len(port) == len(ref)
    for epoch in range(3):
        got, want = list(port), list(ref)
        assert len(got) == len(want), epoch
        for (gx, gy), (wx, wy) in zip(got, want):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


@pytest.mark.parametrize("kind,shape", [("images", (8, 8, 3)),
                                        ("blobs", (5,))])
def test_synthetic_datasets_are_the_reference(kind, shape):
    want = jdata.synthetic_dataset(kind, n=64, classes=4, shape=shape, seed=3)
    got = tdata.synthetic_dataset(kind, n=64, classes=4, shape=shape, seed=3)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        tdata.synthetic_dataset("words")


def test_dataset_arrays_shapes_and_split():
    xt, yt, xe, ye, classes, shape = train_cnn.dataset_arrays(
        "cifar100", n_synth=64)
    assert (xt.shape, xe.shape, classes, shape) == (
        (64, 32, 32, 3), (256, 32, 32, 3), 100, (32, 32, 3))
    assert yt.dtype == ye.dtype == np.int32 and yt.max() < 100
    with pytest.raises(ValueError, match="unknown dataset"):
        train_cnn.dataset_arrays("svhn")


def test_metrics_count_as_the_reference():
    rng = np.random.RandomState(0)
    jacc, tacc = jmetrics.Accuracy(), tmetrics.Accuracy()
    jm, tm = jmetrics.MeanMeter(), tmetrics.MeanMeter()
    for i in range(3):
        logits, labels = rng.randn(6, 5), rng.randint(0, 5, 6)
        jacc.update(logits, labels)
        tacc.update(logits, labels)
        jm.update(float(i) * 1.5, n=i + 1)
        tm.update(float(i) * 1.5, n=i + 1)
    assert (tacc.correct, tacc.total, tacc.value) == (jacc.correct,
                                                      jacc.total, jacc.value)
    assert tm.value == jm.value
    t = tmetrics.Throughput()
    assert t.value == 0.0
    t.update(10)
    assert t.value > 0


def test_peak_flops_is_the_h100_bf16_peak():
    assert tmetrics.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    with pytest.raises(ValueError, match="no peak FLOP/s known"):
        tmetrics.peak_flops("cpu")
