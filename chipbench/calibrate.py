"""Readings that set a cell's limits (``limits/<cell>.json``), on the card
at the cell's own size; the benchmark's own runs never run this.

    python3 chipbench/calibrate.py --workload <cell> --seeds 11,12,13 [--controls 3]

Prints one JSON line a seed. A training cell: the program's compared
numbers (its set-up steps, as a run takes them), the reference's, and on
the first ``--controls`` seeds the control (the reference with bf16
masters, moments and compute) and the fault "half the batch left out,
the mean over the rest" planted in the reference put in the program's
place. A serving cell: a window's worth of ``--requests`` served as a
run serves them, the program's widest logit gap and widest cached-row gap
on the run's sample (with ``--fault``, the program with that fault
planted), and on the first ``--controls`` seeds the control's (the
reference with every product in fp8).
"""

import argparse
import json
import sys
import time
from pathlib import Path

T_START = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))


def train_seed(cell, seed: int, device, control: bool) -> dict:
    import torch

    from chipbench.harness import compare, train_cell
    from chipbench.harness.record import free

    state, step_fn, feed, prog = train_cell.start(cell, seed, device)
    del state, step_fn, feed
    free(device)
    ref = train_cell.reference_readings(cell.config, cell.traffic, seed, device)
    out = {"program": compare.train_readings(prog, ref),
           "program_leaves": compare.leaf_diffs(prog["change_sample"], ref["change_sample"],
                                                compare.moved_leaves(ref["grad_norm"]))}
    if control:
        ctrl = train_cell.reference_readings(cell.config, cell.traffic, seed, device,
                                             dtype=torch.bfloat16)
        out["control"] = compare.train_readings(ctrl, ref)
        half = train_cell.reference_readings(cell.config, cell.traffic, seed, device,
                                             rows=slice(0, cell.traffic["batch"] // 2))
        out["half_batch"] = compare.train_readings(half, ref)
    return out


def serve_seed(cell, seed: int, device, control: bool, n_requests: int, fault: str = "") -> dict:
    import torch

    from chipbench import faults
    from chipbench.harness import serve_cell
    from chipbench.harness.record import free
    from chipbench.reference import lowp

    srv = serve_cell.Server(cell, seed, device,
                            {"model": faults.SERVE[fault]} if fault else None)
    first = len(srv.filled) + len(srv.served)
    for _ in range(n_requests):
        srv.serve()
    outputs = srv.outputs()
    del srv
    free(device)
    sample = serve_cell.sample_requests(seed, first, n_requests, cell.traffic["sampled_requests"])
    params = serve_cell.reference_params(cell.config, seed, device)
    worst = {"program": [0.0, 0.0], "control": [0.0, 0.0]}
    for i in sample:
        req, res, rows = outputs[i]
        served = torch.as_tensor(res.output[0], dtype=torch.int64, device=device)
        for side in ("program", "control") if control else ("program",):
            gaps, kv = serve_cell.request_gaps(params, cell.config, req.tokens, served, rows,
                                               device, quant=lowp.fp8 if side == "control" else None)
            worst[side] = [max(worst[side][0], float(gaps.max())), max(worst[side][1], kv)]
    if not control:
        del worst["control"]
    if fault:
        worst[fault] = worst.pop("program")
    n = f"{len(sample)} requests"
    return {k: {"logit_gap": [v[0], n], "kv_row_gap": [v[1], n]} for k, v in worst.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--requests", type=int, default=40)
    ap.add_argument("--fault", default="", help="a serving fault planted in the program "
                    "(chipbench/faults.py: altered_token, cache_unchanged)")
    args = ap.parse_args()

    import torch

    from chipbench.harness import manifest

    device = torch.device("cuda", 0)
    cell = manifest.cell(manifest.load(ROOT), args.workload, ROOT)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if cell.traffic["kind"] == "train":
            out = train_seed(cell, seed, device, i < args.controls)
        else:
            out = serve_seed(cell, seed, device, i < args.controls, args.requests, args.fault)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
