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

A cell on more than one chip is calibrated as it runs (``run.py``'s
launch): one process a card, each seed's readings gathered from every
rank onto one line, under ``"ranks"`` in rank order.
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

from chipbench import run  # noqa: E402

CALIBRATE_TIMEOUT_S = 3500.0    # a dozen seeds and their controls, on every rank


def train_seed(cell, seed: int, device, control: bool) -> dict:
    import torch

    from chipbench.harness import compare, train_cell
    from chipbench.harness.record import free

    state, step_fn, feed, prog = train_cell.start(cell, seed, device)
    del state, step_fn, feed
    free(device)
    share = dict(rank=cell.ranks.rank, world=cell.ranks.world)
    ref = train_cell.reference_readings(cell.config, cell.traffic, seed, device, **share)
    out = {"program": compare.train_readings(prog, ref),
           "program_leaves": compare.leaf_diffs(prog["change_sample"], ref["change_sample"],
                                                compare.moved_leaves(ref["grad_norm"]))}
    if control:
        ctrl = train_cell.reference_readings(cell.config, cell.traffic, seed, device,
                                             dtype=torch.bfloat16, **share)
        out["control"] = compare.train_readings(ctrl, ref)
        half = train_cell.reference_readings(cell.config, cell.traffic, seed, device,
                                             rows=slice(0, cell.traffic["batch"] // 2), **share)
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
    params = serve_cell.reference_params(cell.config, seed, device, cell.ranks.rank,
                                         cell.ranks.world)
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
    run.add_rank_args(ap)
    argv = sys.argv[1:]
    args = ap.parse_args(argv)

    import torch

    from chipbench.harness import manifest

    cell = manifest.cell(manifest.load(ROOT), args.workload, ROOT)
    if args.rank is None and cell.chips > 1:
        return run.launch([sys.executable, str(Path(__file__).resolve())] + argv, cell.chips,
                          timeout_s=CALIBRATE_TIMEOUT_S, t0=T_START)
    run.join(cell, args, torch.device("cuda", args.rank or 0))
    device = cell.ranks.device
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        if cell.traffic["kind"] == "train":
            out = train_seed(cell, seed, device, i < args.controls)
        else:
            out = serve_seed(cell, seed, device, i < args.controls, args.requests, args.fault)
        outs = cell.ranks.gather(out)
        if outs is not None:
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "seconds": time.perf_counter() - t0,
                              **(outs[0] if len(outs) == 1 else {"ranks": outs})}), flush=True)
    if cell.ranks.world > 1:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
