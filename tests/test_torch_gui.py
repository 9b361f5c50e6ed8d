"""The port's result pager (``unflow_tpu_torch/eval/gui.py``) against the JAX
package's (``unflow_tpu/eval/gui.py``): on the Agg backend, with
``plt.show`` caught, both draw the same four panels for the same results,
and the keys page forward, back and around."""

import matplotlib
import numpy as np
import pytest

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from matplotlib.backend_bases import KeyEvent  # noqa: E402

from unflow_tpu.eval.gui import display as display_jax  # noqa: E402
from unflow_tpu_torch.eval.gui import display  # noqa: E402


def _results(rng, n=3, h=12, w=20, gt=True):
    out = []
    for _ in range(n):
        entry = {"im1": rng.rand(h, w, 3).astype(np.float32),
                 "flow": (rng.randn(h, w, 2) * 3).astype(np.float32)}
        if gt:
            entry["gt"] = (rng.randn(h, w, 2) * 3).astype(np.float32)
            entry["mask"] = (rng.rand(h, w, 1) > 0.3).astype(np.float32)
        out.append(entry)
    return out


@pytest.fixture()
def shown(monkeypatch):
    figures = []
    monkeypatch.setattr(plt, "show", lambda: figures.append(plt.gcf()))
    yield figures
    plt.close("all")


def _panels(fig):
    return [(ax.get_title(), [np.asarray(im.get_array()) for im in ax.get_images()])
            for ax in fig.axes]


def _press(fig, key):
    fig.canvas.callbacks.process("key_press_event", KeyEvent("key_press_event", fig.canvas, key))


@pytest.mark.parametrize("gt", [True, False], ids=["with_gt", "without_gt"])
def test_display_draws_what_the_jax_one_draws(rng, shown, gt):
    results = _results(rng, gt=gt)
    display_jax(results)
    display(results)
    want, got = (_panels(fig) for fig in shown)
    assert [t for t, _ in got] == [t for t, _ in want]
    assert got[0][0] == "frame 1 [1/3]"
    assert sum(bool(images) for _, images in got) == (4 if gt else 2)
    for (_, mine), (_, theirs) in zip(got, want):
        assert len(mine) == len(theirs)
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a, b)


def test_keys_page_forward_and_back(rng, shown):
    results = _results(rng)
    display(results)
    display_jax(results)
    fig, fig_jax = shown
    for key, index in (("n", 2), ("right", 3), ("n", 1), ("p", 3), ("left", 2), ("x", 2)):
        _press(fig, key)
        _press(fig_jax, key)
        assert fig.axes[0].get_title() == f"frame 1 [{index}/3]", key
        np.testing.assert_array_equal(fig.axes[0].get_images()[0].get_array(),
                                      results[index - 1]["im1"])
        for (t, mine), (u, theirs) in zip(_panels(fig), _panels(fig_jax)):
            assert t == u
            for a, b in zip(mine, theirs):
                np.testing.assert_array_equal(a, b)
    _press(fig, "q")
    assert not plt.fignum_exists(fig.number)
