"""Matplotlib pager of evaluation results (``cli.eval --gui``).

Port of ``unflow_tpu/eval/gui.py``: a window of four panels per example
(frame 1, predicted flow, ground-truth flow, error image), paged with the
keys. matplotlib is imported when the pager opens, so headless evaluation
never needs it.
"""

from __future__ import annotations

from unflow_tpu_torch.eval.flow_viz import flow_error_image, flow_to_color


def import_pyplot():
    """``matplotlib.pyplot``, or an ImportError that says what needs it."""
    try:
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError("the --gui pager needs matplotlib, which is not installed") from e
    return plt


def display(results: list[dict]) -> None:
    """Page through evaluation results.

    Each entry: ``{'im1': (H, W, 3), 'flow': (H, W, 2)[, 'gt': (H, W, 2),
    'mask': (H, W, 1)]}`` (``Evaluator.run(collect=...)``'s ``entries``).
    Keys: n or right for the next, p or left for the previous, q to quit."""
    plt = import_pyplot()
    state = {"idx": 0}
    fig, axes = plt.subplots(2, 2, figsize=(12, 6))

    def render():
        entry = results[state["idx"]]
        for ax in axes.flat:
            ax.clear()
            ax.axis("off")
        axes[0, 0].imshow(entry["im1"])
        axes[0, 0].set_title(f"frame 1 [{state['idx'] + 1}/{len(results)}]")
        axes[0, 1].imshow(flow_to_color(entry["flow"]))
        axes[0, 1].set_title("predicted flow")
        if "gt" in entry:
            axes[1, 0].imshow(flow_to_color(entry["gt"]))
            axes[1, 0].set_title("ground truth")
            axes[1, 1].imshow(flow_error_image(entry["flow"], entry["gt"], entry.get("mask")))
            axes[1, 1].set_title("error")
        fig.canvas.draw_idle()

    def on_key(event):
        if event.key in ("n", "right"):
            state["idx"] = (state["idx"] + 1) % len(results)
            render()
        elif event.key in ("p", "left"):
            state["idx"] = (state["idx"] - 1) % len(results)
            render()
        elif event.key == "q":
            plt.close(fig)

    fig.canvas.mpl_connect("key_press_event", on_key)
    render()
    plt.show()
