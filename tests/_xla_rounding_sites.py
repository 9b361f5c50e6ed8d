"""Where XLA rounds the JAX package's bfloat16 train step (ROADMAP C2).

    JAX_PLATFORMS=cpu python tests/_xla_rounding_sites.py

Compiles the held-out recipe's bf16 step (64x128, batch 2, D = 21, no
augmentation; ``tests/test_torch_trajectory.py``'s) twice on the CPU, in
child processes: as XLA compiles it by default and with
``--xla_allow_excess_precision=false`` (held to the program's rounding). In
each optimized HLO it finds the values rounded to bfloat16 (a ``convert`` to
bf16) and prints, by the JAX op that produced them, where the two
compilations round a different number of times; then, for every convolution
(forward, data gradient, filter gradient, by layer), whether every consumer
rounds its output to bf16 first ("R") or reads it in float32.
"""

import collections
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
DUMP = """
import sys, tempfile
sys.path.insert(0, {root!r})
import jax
jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
from pathlib import Path
from tests.test_torch_trajectory import jax_init, recipe_configs
from unflow_tpu.train.trainer import TrainState, build_optimizer, make_train_step
from unflow_tpu_torch import heldout
from unflow_tpu_torch.data.synthetic import corpus_iterator
b = next(corpus_iterator(2, 64, 128, n_pairs=8, seed=0, mode=heldout.DATA_MODE,
                         max_shift=heldout.MAX_SHIFT, dtype="uint8"))
_, cfg = recipe_configs(Path(tempfile.mkdtemp()), 1, dtype="bfloat16", augment=False,
                        max_displacement=20)
model, params = jax_init(cfg, (64, 128))
tx = build_optimizer(cfg, params)
state = TrainState(jnp.zeros((), jnp.int32), params, tx.init(params))
step = jax.jit(make_train_step(model, tx, cfg))
lowered = step.lower(state, {{k: jnp.asarray(v) for k, v in b.items()}}, jax.random.PRNGKey(0))
open({out!r}, "w").write(lowered.compile().as_text())
"""


def parse(path: str) -> dict[str, list[dict]]:
    """Computation name -> its instructions (name, type, op, operands,
    called computation, the JAX op name of its metadata)."""
    comps, cur = {}, None
    for line in open(path):
        head = re.match(r"^(ENTRY )?%?([\w.\-]+) .*\{\s*$", line)
        if head and not line.startswith("  "):
            cur = comps.setdefault(head.group(2), [])
            continue
        m = re.match(r"^\s+(ROOT )?%([\w.\-]+) = (\S+) ([\w\-]+)\((.*)$", line)
        if m and cur is not None:
            rest = m.group(5)
            calls = re.search(r"calls=%([\w.\-]+)", rest)
            meta = re.search(r'op_name="([^"]*)"', rest)
            cur.append({"name": m.group(2), "type": re.sub(r"\{[^}]*\}", "", m.group(3)),
                        "op": m.group(4),
                        "operands": re.findall(r"%([\w.\-]+)", rest.split("),")[0]),
                        "calls": calls.group(1) if calls else None,
                        "meta": meta.group(1) if meta else ""})
    return comps


def roundings(comps) -> collections.Counter:
    """The bf16 converts, by what they round: the producing op and the last
    parts of its JAX op name (fusion parameters by their consumers' op)."""
    out = collections.Counter()
    for ins in comps.values():
        by = {i["name"]: i for i in ins}
        users = collections.defaultdict(list)
        for i in ins:
            for o in i["operands"]:
                users[o].append(i)
        for i in ins:
            if i["op"] != "convert" or not i["type"].startswith("bf16") or not i["operands"]:
                continue
            src = by.get(i["operands"][0])
            if src is None:
                continue
            if src["op"] == "parameter":
                read = sorted({u["op"] for c in users[i["name"]]
                               for u in (users[c["name"]] if c["op"] == "convert" else [c])})
                key = ("parameter", "/".join(src["meta"].split("/")[-2:]), ",".join(read))
            else:
                key = (src["op"], "/".join(src["meta"].split("/")[-2:]), "")
            out[key] += 1
    return out


def conv_outputs(comps) -> dict[tuple, str]:
    """For each convolution (layer, forward or backward, output shape):
    "R" when every consumer rounds it to bf16 before reading it, else the
    ops that read it in float32."""
    out = {}
    for ins in comps.values():
        users = collections.defaultdict(list)
        for i in ins:
            for o in i["operands"]:
                users[o].append(i)
        for i in ins:
            if i["op"] != "convolution":
                continue
            kind = ("bwd" if "transpose(" in i["meta"] else
                    "fwd" if "jvp(" in i["meta"] else "(no op name)")
            reads = set()
            for u in users[i["name"]]:
                if u["op"] != "fusion":
                    reads.add(u["op"])
                    continue
                body = comps[u["calls"]]
                k = u["operands"].index(i["name"])
                param = [x for x in body if x["op"] == "parameter"
                         and re.search(rf"param_{k}\.", x["name"])]
                first = [x for x in body if param and param[0]["name"] in x["operands"]]
                if first and all(x["op"] == "convert" and x["type"].startswith("bf16")
                                 for x in first):
                    reads.add("R")
                else:
                    reads.update(x["op"] for x in first)
            parts = i["meta"].split("/")
            layer = parts[-2] if len(parts) > 1 else "(no op name)"
            out[(layer, kind, i["type"])] = ",".join(sorted(reads))
    return out


def main() -> int:
    tmp = Path(tempfile.mkdtemp())
    hlo = {}
    for name, flags in (("default", ""), ("held", "--xla_allow_excess_precision=false")):
        path = str(tmp / f"{name}.txt")
        env = {**os.environ, "JAX_PLATFORMS": "cpu", "XLA_FLAGS": flags}
        subprocess.run([sys.executable, "-c", DUMP.format(root=str(ROOT), out=path)],
                       env=env, cwd=ROOT, check=True)
        hlo[name] = parse(path)
    d, h = roundings(hlo["default"]), roundings(hlo["held"])
    print(f"bf16 roundings: default {sum(d.values())}, held {sum(h.values())}")
    print(f"{'default':>8} {'held':>5}  (what is rounded: op, JAX op, read by)")
    for key in sorted(set(d) | set(h)):
        if d[key] != h[key]:
            print(f"{d[key]:8d} {h[key]:5d}  {key}")
    cd, ch = conv_outputs(hlo["default"]), conv_outputs(hlo["held"])
    print("convolutions whose output the two compilations read differently "
          "(R: rounded to bf16 first):")
    for key in sorted(set(cd) | set(ch)):
        if cd.get(key) != ch.get(key):
            print(f"  {key}: default {cd.get(key)}, held {ch.get(key)}")
    same = sum(cd.get(k) == ch.get(k) for k in cd)
    print(f"  ({same} of {len(cd)} convolutions read alike)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
