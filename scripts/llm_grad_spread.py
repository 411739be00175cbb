"""How far the first-step gradients of a cut full-width model move, leaf
by leaf, when its kernels run, against the plain versions, over several
seeds, on one NVIDIA GPU; and for RWKV-6, how far two witnesses that
change only wkv6's rounding move them.

    python3 scripts/llm_grad_spread.py [--arch rwkv6-7b] [--seeds 6]

For each seed s in 0 .. seeds-1 the weights of the model at full width
with ``chip_smoke.py``'s phase 10 (c) or (c') depth are drawn from seed
s and the batch is the ``TokenStream`` batch 1 of seed s (4 x 512). In
bf16 and in fp32 the gradient of the RL loss is taken on the card
through the plain versions and through the kernels, and for RWKV-6
through two witnesses:

* ``chunked``: the kernel's own ``autograd.Function`` with its binding
  replaced by ``wkv6_chunked_ref``, the kernel's chunked algorithm in
  plain PyTorch (fp32 on the CUDA cores where the kernel runs 3xTF32);
* ``reordered``: the plain version with o summed in another order
  (``chip_smoke.wkv6_reordered``), the smallest change of rounding.

It prints, per seed and dtype, each run's relative L2 distance from the
plain run for every ``mixer.u`` leaf and the largest over the other
leaves (with its name), the loss's difference and, for an MoE arch, the
two runs' routing (``chip_smoke.routing_diff``); at the end one JSON
line with every reading and a summary per dtype and group: the kernel
run's largest, each witness's smallest, and the largest ratio of the
kernel run's distance to each witness's on the same seed.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (sets CUBLAS_WORKSPACE_CONFIG, src path)
import torch  # noqa: E402


def _groups(rel: dict) -> dict:
    """The ``mixer.u`` leaves one by one, and the largest of the rest."""
    out = {n: v for n, v in rel.items() if n.endswith("mixer.u")}
    out["other (largest)"] = max(v for n, v in rel.items()
                                 if not n.endswith("mixer.u"))
    return out


def _witnesses(arch: str) -> dict:
    """name -> (use_kernel, the patch that makes the witness)."""
    if arch != "rwkv6-7b":
        return {}
    from repro_torch.kernels.wkv6 import kernel as wkv_kernel
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.kernels.wkv6.ref import wkv6_chunked_ref

    def reordered(r, k, v, w, u, s0=None, *, use_kernel=True):
        return chip_smoke.wkv6_reordered(r, k, v, w, u, s0)

    return {"chunked": (True, lambda: mock.patch.object(
                wkv_kernel, "wkv6", wkv6_chunked_ref)),
            "reordered": (False, lambda: mock.patch.object(
                wkv_ops, "mix", reordered))}


def _summarize(readings: list, group: list, witnesses) -> dict:
    out = {"kernel_max": max(r["kernel"][n] for r in readings
                             for n in group)}
    for w in witnesses:
        pairs = [(r["kernel"][n], r[w][n]) for r in readings for n in group]
        out[f"{w}_min"] = min(x for _, x in pairs)
        out[f"ratio_to_{w}_max"] = max(k / x for k, x in pairs)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    depth = {**{a: n for a, (n, _) in chip_smoke.LLM_SPEC_RUNS.items()},
             **chip_smoke.LLM_FIRST_STEP}
    ap.add_argument("--arch", default="rwkv6-7b", choices=sorted(depth))
    ap.add_argument("--seeds", type=int, default=6)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from repro_torch import models
    from repro_torch.core import determinism
    from repro_torch.data.pipeline import TokenStream

    smi = chip_smoke.nvidia_smi()
    n_layers = depth[args.arch]
    witnesses = _witnesses(args.arch)
    seeds = range(args.seeds)
    result = {"arch": args.arch, "n_layers": n_layers, "device": smi,
              "seeds": list(seeds), "summary": {}, "readings": {}}
    for dtype in ("bfloat16", "float32"):
        policy = models.get_policy("backbone", None, arch=args.arch,
                                   n_layers=n_layers, dtype=dtype,
                                   use_pallas_attention=True)
        cfg = policy.config
        readings = []
        for seed in seeds:
            params = policy.init(determinism.master_key(seed, device="cuda"))
            batch = {k: v.cuda() for k, v in TokenStream(
                cfg.vocab_size, chip_smoke.LLM_BATCH, chip_smoke.LLM_SEQ,
                seed).skip(1).next_batch().items()}
            with chip_smoke.recording_routes() as r_plain:
                l_plain, g_plain = chip_smoke._train_grads(cfg, params,
                                                           batch, False)
            row = {"seed": seed}
            for name, (use_kernel, patch) in [
                    ("kernel", (True, None)), *witnesses.items()]:
                if patch is None:
                    with chip_smoke.recording_routes() as r_kernel:
                        loss, g = chip_smoke._train_grads(cfg, params,
                                                          batch, True)
                    row["loss_diff"] = abs(loss - l_plain)
                else:
                    with patch():
                        _, g = chip_smoke._train_grads(cfg, params, batch,
                                                       use_kernel)
                rel = chip_smoke._rel_l2(g, g_plain)
                row[name] = _groups(rel)
                if name == "kernel":
                    row["largest"] = max(rel, key=rel.get)
                del g
            if cfg.n_experts:
                row["routing"] = chip_smoke.routing_diff(
                    r_kernel, r_plain, cfg.top_k,
                    f"{dtype} seed {seed}, kernels vs plain versions")
            del r_kernel, r_plain
            del g_plain, params
            torch.cuda.empty_cache()
            readings.append(row)
            print(f"{dtype} seed {seed}: " + "; ".join(
                f"{n} " + ", ".join(f"{w} {row[w][n]:.4e}"
                                    for w in ["kernel", *witnesses])
                for n in row["kernel"]) + f" ({row['largest']}); loss "
                f"|diff| {row['loss_diff']:.3e}", flush=True)
        names = list(readings[0]["kernel"])
        summary = {n: _summarize(readings, [n], witnesses) for n in names}
        u = [n for n in names if n.endswith("mixer.u")]
        if u:
            summary["mixer.u (all layers)"] = _summarize(readings, u,
                                                         witnesses)
        result["summary"][dtype] = summary
        result["readings"][dtype] = readings
        del policy
        torch.cuda.empty_cache()
    print(f"{args.arch} n_layers={n_layers}, seeds 0..{args.seeds - 1}, "
          f"on {smi}:")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
