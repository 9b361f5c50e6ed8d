"""The work of a FlowNet cascade, counted from its shapes alone.

A multiply-add is two operations. Counted: every conv (``2 * B * H_out *
W_out * C_out * C_in * k * k``), every 4x4/2 transposed conv at its dense
size with no inserted zeros (``2 * B * H_in * W_in * C_in * C_out * 16``)
and the correlation (``2 * B * H * W * D^2 * C``). A training step counts
the forward of every stage, and for each trainable stage the data and
filter gradients of its convs and both gradients of its correlation, but no
gradient into the stage's input (its images, or what the frozen stages
before it made), nothing recomputed to save memory, and none of the census
patches, resizes, warps or elementwise work. So the count is the work the
architecture needs, whatever carries it out.
"""

from __future__ import annotations

from flowbench.reference.flownet import _DECODER_CONVS, _DECODER_DECONVS, displacements, stage_convs


def _out(size: int, stride: int) -> int:
    return -(-size // stride)


def stage_flops(kind: str, in_channels: int, rows: int, h: int, w: int, d: int,
                corr_rows: int | None = None) -> dict:
    """Forward operations of one stage on ``rows`` inputs of ``h x w``, split
    into ``first`` (the first conv, whose data gradient is never needed),
    ``convs`` (every other conv and transposed conv) and ``corr``.
    ``corr_rows``: the correlation's batch, when the tower runs on both
    frames stacked (inference)."""
    sizes = {}  # output size of each named conv
    total = {"first": 0, "convs": 0, "corr": 0}
    tower_rows = rows
    trunk_rows = rows if corr_rows is None else corr_rows
    for name, cin, cout, k, s in stage_convs(kind, in_channels, d):
        src = {"conv1": (h, w), "conv2": sizes.get("conv1"), "conv3": sizes.get("conv2"),
               "conv_redir": sizes.get("conv3"), "conv3_1": sizes.get("conv3")}.get(name)
        if src is None:
            src = sizes[_PREV[name]]
        oh, ow = _out(src[0], s), _out(src[1], s)
        sizes[name] = (oh, ow)
        b = tower_rows if name in ("conv1", "conv2", "conv3") else trunk_rows
        ops = 2 * b * oh * ow * cout * cin * k * k
        total["first" if name == "conv1" else "convs"] += ops
    if kind == "C":
        ch, cw = sizes["conv3"]
        total["corr"] = 2 * trunk_rows * ch * cw * d * d * 256
    # decoder: a flow head at each of five scales, a deconv and an upflow
    # into each of the four finer ones
    scales = [sizes["conv6_1"], sizes["conv5_1"], sizes["conv4_1"], sizes["conv3_1"], sizes["conv2"]]
    for (name, cin), (oh, ow) in zip(_DECODER_CONVS, scales):
        total["convs"] += 2 * trunk_rows * oh * ow * 2 * cin * 9
    for i, (name, cin, cout) in enumerate(_DECODER_DECONVS):
        ih, iw = scales[i // 2]
        total["convs"] += 2 * trunk_rows * ih * iw * cin * cout * 16
    return total


_PREV = {"conv4": "conv3_1", "conv4_1": "conv4", "conv5": "conv4_1", "conv5_1": "conv5",
         "conv6": "conv5_1", "conv6_1": "conv6"}


def train_step_flops(spec: str, batch: int, h: int, w: int, max_displacement: int = 20,
                     stride: int = 2) -> int:
    """One unsupervised step: every stage on the ``2 * batch`` directed
    pairs; a trainable stage three times (forward, data and filter
    gradients) but its first conv twice, its correlation three times."""
    d = displacements(max_displacement, stride)
    total = 0
    for i, ch in enumerate(spec):
        kind = ch.upper()
        f = stage_flops(kind, 3 if kind == "C" else (6 if i == 0 else 12), 2 * batch, h, w, d)
        if ch.isupper():
            total += 2 * f["first"] + 3 * f["convs"] + 3 * f["corr"]
        else:
            total += f["first"] + f["convs"] + f["corr"]
    return total


def infer_flops(spec: str, batch: int, h: int, w: int, max_displacement: int = 20,
                stride: int = 2) -> int:
    """One forward of ``batch`` pairs at the padded ``h x w``: FlowNetC's
    tower runs on both frames."""
    d = displacements(max_displacement, stride)
    total = 0
    for i, ch in enumerate(spec):
        kind = ch.upper()
        if kind == "C" and i == 0:
            f = stage_flops(kind, 3, 2 * batch, h, w, d, corr_rows=batch)
        else:
            f = stage_flops(kind, 6 if i == 0 else 12, batch, h, w, d)
        total += sum(f.values())
    return total
