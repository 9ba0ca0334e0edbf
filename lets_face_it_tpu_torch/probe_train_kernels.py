"""Probe of the training kernels' launch plan on one NVIDIA GPU.

    python -m lets_face_it_tpu_torch.probe_train_kernels [--precision highest|high|medium]
        [--hidden_channels H] [--expression_dim E] [--n_steps K] [--batch B]
        [--quick] [--plan walk|hsplit]
    python -m lets_face_it_tpu_torch.probe_train_kernels --gates

For ``hparams/final_model.yaml`` on seeded random weights at B=256, N=56
(the training path's shape), or a wider spec of the search grid with
``--hidden_channels`` / ``--expression_dim`` / ``--n_steps`` at ``--batch``
rows (e.g. H = 512, E = 48, B = 64: chip_smoke.py step 18's), from the
sources in this checkout:

1. builds the kernels and prints the registers and spills ``nvcc -Xptxas -v``
   reports for ``cond_gates``, ``seq_fwd`` and ``seq_bwd`` (each plan's
   library);
2. holds ``cond_gates``, ``seq_fwd`` and ``seq_bwd`` against their plain
   versions at B=256 and at B=5 (a partial cluster) with the launcher's own
   plan (forward atol/rtol 1e-5, backward atol 2e-5 / rtol 1e-4), and
   ``seq_fwd`` and ``seq_bwd`` on each of their plans ("walk", "hsplit";
   ``train_kernels.seq_fwd_plan_name``, ``seq_bwd_plan_name``) at the
   same limits, each timed by CUDA-graph replay at B=256 (the forward's
   serial chain alone); a plan that does not take the spec says why
   (``--quick`` stops here);
3. ``--plan walk`` (the default): for every cluster size in (1, 2, 4, 8)
   and rows per block in (1, 2, 4, 8), and for ring slots in (2, 3, 4, 6)
   at the default plan's rows per block and clusters of 1 and 2;
   ``--plan hsplit``: for every cluster of the hidden split
   (``train_kernels.HSPLIT_CLUSTERS``) and rows per block, and for ring
   slots at its default rows and cluster: prints the plan (blocks, slots,
   slot and shared-memory bytes, and the clusters the device holds at once,
   by ``cudaOccupancyMaxActiveClusters``), holds both serial kernels against
   the plain versions again and times them by CUDA-graph replay; then times
   ``cond_gates`` beside one cuBLAS call for the same product.

``--gates`` runs only ``cond_gates``' two plans ("simt" and "tc", each on
each of its tiles, ``train_kernels.COND_GATES_TILES``), at every
matmul precision, at B=256 and B=64 (N=56): each held against the plain
version (forward limits at "highest", 4 grid steps at the reduced modes)
and, at "highest", its root mean square from the float64 product beside
the plain version's; each timed by CUDA-graph replay beside one cuBLAS
``baddbmm`` at torch's same setting. The launcher's plan and default tile
at each mode are read from these rows.

``--precision`` runs every kernel and plain version at that matmul
precision (``ops/flow_kernels.py::MODES``); at "high" and "medium" the
checks hold the largest |difference| to 4 steps of the mode's grid (2^-10
TF32, 2^-7 bf16) of the output's largest |value|, as chip_smoke.py does.

One JSON line per reading, the card's name and power limit first. Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import tempfile
from pathlib import Path

import torch

from lets_face_it_tpu_torch.hparams import load_hparams
from lets_face_it_tpu_torch.model.spec import FlowSpec
from lets_face_it_tpu_torch.ops import cuda_build
from lets_face_it_tpu_torch.ops import flow_kernels as fk
from lets_face_it_tpu_torch.ops import train_kernels as tk
from lets_face_it_tpu_torch.probe_sampling_kernels import widened
from lets_face_it_tpu_torch.sample.weights import seeded_random_model
from lets_face_it_tpu_torch.utils.precision import matmul_precision
from lets_face_it_tpu_torch.utils.timing import cuda_time_ms, graphed

REPO = Path(__file__).resolve().parent.parent
SEED = 20240
CLUSTERS = (1, 2, 4, 8)
ROWS_PER_BLOCK = (1, 2, 4, 8)
SLOTS = (2, 3, 4, 6)   # ring slots tried at the default plan's rows per block
FWD_TOL, BWD_TOL = (1e-5, 1e-5), (2e-5, 1e-4)
# at a reduced precision: steps of its grid, of the output's largest |value|
MODE_GRID, MODE_STEPS = {"high": 2.0 ** -10, "medium": 2.0 ** -7}, 4.0


def _time_ms(fn, reps=5):
    """Mean ms per replay of ``fn`` captured in a CUDA graph (CUDA events;
    one call before the capture, one replay before the timed ones)."""
    return cuda_time_ms(graphed(fn, warmup=1), reps, warmup=1)


def _max_err(name, got, ref, tol, precision="highest"):
    worst = 0.0
    for i, (a, r) in enumerate(zip(got, ref)):
        atol, rtol = tol
        if precision != "highest":
            atol = MODE_STEPS * MODE_GRID[precision] * max(r.abs().max().item(), 1.0)
            rtol = 0.0
        err = (a.double() - r.double()).abs()
        if not torch.isfinite(a).all() or (err > atol + rtol * r.double().abs()).any():
            raise SystemExit(f"{name} output {i}: max|diff| {err.max().item():.3e} "
                             f"exceeds atol {atol} + rtol {rtol}*|ref|")
        worst = max(worst, err.max().item())
    return worst


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--precision", default="highest", choices=tuple(fk.MODES))
    parser.add_argument("--gates", action="store_true",
                        help="only cond_gates' plans, at every precision")
    parser.add_argument("--hidden_channels", type=int, default=None)
    parser.add_argument("--expression_dim", type=int, default=None)
    parser.add_argument("--n_steps", type=int, default=None, help="flow steps K")
    parser.add_argument("--batch", type=int, default=None,
                        help="rows (default: the config's batch size)")
    parser.add_argument("--quick", action="store_true",
                        help="the checks and every plan of both kernels only")
    parser.add_argument("--plan", default="walk", choices=tk.SEQ_FWD_PLANS,
                        help="the plan whose tiles the grid tries")
    args = parser.parse_args(argv)
    prec = args.precision
    mode = fk.MODES[prec]
    if not torch.cuda.is_available():
        raise SystemExit("this probe needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.gates:
        return _probe_gates()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0]
    print(json.dumps({"card": card.strip(), "torch": torch.__version__,
                      "precision": prec}))

    paths = cuda_build.build(("cond_gates", "seq_fwd", "seq_bwd", "seq_fwd_hsplit",
                              "seq_bwd_hsplit"))
    for name, path in paths.items():
        log = path.with_suffix(".log")
        for line in log.read_text().splitlines() if log.exists() else ():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(json.dumps({"ptxas": name, "line": line.strip()}))

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        hp = widened(load_hparams(REPO / "hparams" / "final_model.yaml",
                                  dataset_root=tmp),
                     args.hidden_channels, args.expression_dim, args.n_steps)
    spec = FlowSpec.build(hp)
    n = hp.Train["seq_len"] - spec.cond.longest_history
    k, c, h = spec.n_steps, spec.channels, spec.hidden_channels
    big = args.batch or hp.batch_size
    spec = fk.kernel_spec(spec)   # the wrappers below take the kernels' lanes
    c = spec.channels
    print(json.dumps({"spec": {"C": hp.Data["expression_dim"] + hp.Data["jaw_dim"]
                               + hp.Data["neck_dim"], "lanes": c, "K": k, "H": h,
                               "cond": spec.cond.cond_dim},
                      "seq_fwd_plan": tk.seq_fwd_plan_name(spec),
                      "seq_bwd_plan": tk.seq_bwd_plan_name(spec)}))
    model = seeded_random_model(spec, SEED).to(dev)
    g = torch.Generator(device=dev).manual_seed(SEED)

    def inputs(b, frames):
        xs = torch.randn(frames, b, c, generator=g, device=dev)
        cs = torch.randn(frames, k, b, spec.cond.cond_dim, generator=g, device=dev)
        st0 = 0.3 * torch.randn(k, b, h, generator=g, device=dev)
        return xs, cs, st0

    with torch.no_grad():
        tw = tk.prepare_train_weights(spec, model.flow)
        cases = {}
        for b, frames in ((5, 5), (big, n)):
            xs, cs, st0 = inputs(b, frames)
            ref = tk.seq_fwd_ref(spec, tw, xs, cs, st0, mode)
            hprev = torch.cat([st0[None], ref[3][:-1]])
            cot = (torch.randn(xs.shape, generator=g, device=dev),
                   torch.randn(ref[1].shape, generator=g, device=dev),
                   torch.randn(st0.shape, generator=g, device=dev))
            gc = ref[4]
            bwd_ref = tk.seq_bwd_ref(spec, tw, gc, ref[2], hprev, *cot, mode)
            e_gc = _max_err("cond_gates", [tk.cond_gates(spec, tw, cs, precision=prec)],
                            [gc], FWD_TOL, prec)
            e_f = _max_err(f"seq_fwd B={b}",
                           tk.seq_fwd(spec, tw, xs, cs, st0, precision=prec), ref,
                           FWD_TOL, prec)
            e_b = _max_err(f"seq_bwd B={b}",
                           tk.seq_bwd(spec, tw, gc, ref[2], hprev, *cot, precision=prec),
                           bwd_ref, BWD_TOL, prec)
            fwd_by_plan, by_plan = {}, {}
            for plan in tk.SEQ_FWD_PLANS:
                def fwd(plan=plan):
                    return tk.seq_fwd_serial(spec, tw, xs, gc, st0, precision=prec,
                                             plan=plan)
                fwd_by_plan[plan] = _plan_row(f"seq_fwd {plan} B={b}", "seq_fwd", spec,
                                              b, plan, fwd, ref[:4], FWD_TOL, prec,
                                              b == big)
            for plan in tk.SEQ_BWD_PLANS:
                def bwd(plan=plan):
                    return tk.seq_bwd(spec, tw, gc, ref[2], hprev, *cot,
                                      precision=prec, plan=plan)
                by_plan[plan] = _plan_row(f"seq_bwd {plan} B={b}", "seq_bwd", spec, b,
                                          plan, bwd, bwd_ref, BWD_TOL, prec, b == big)
            torch.cuda.synchronize()
            print(json.dumps({"check": "default plan", "batch": b, "frames": frames,
                              "fwd_plan": tk.serial_plan("seq_fwd", spec, b),
                              "bwd_plan": tk.serial_plan("seq_bwd", spec, b),
                              "max_abs_err": {"cond_gates": e_gc, "seq_fwd": e_f,
                                              "seq_bwd": e_b},
                              "seq_fwd_plans": fwd_by_plan,
                              "seq_bwd_plans": by_plan}), flush=True)
            cases[b] = (xs, cs, st0, ref, hprev, cot, bwd_ref)
        if args.quick:
            return 0

        b = big
        xs, cs, st0, ref, hprev, cot, bwd_ref = cases[b]
        gc = ref[4]
        hsplit = args.plan == "hsplit"
        fwd_plan = "hsplit" if hsplit else "walk"
        bwd_plan = "hsplit" if hsplit else None
        if hsplit:
            d = tk.serial_plan("seq_bwd", spec, b, plan="hsplit")
            grid = [(bt, cs_n, 0) for cs_n in tk.HSPLIT_CLUSTERS for bt in ROWS_PER_BLOCK]
            grid += [(d["rows_per_block"], d["cluster"], slots) for slots in SLOTS]
        else:
            bt0 = tk.serial_plan("seq_bwd", spec, b)["rows_per_block"]
            grid = [(bt, cs_n, 0) for cs_n in CLUSTERS for bt in ROWS_PER_BLOCK]
            grid += [(bt0, cs_n, slots) for cs_n in CLUSTERS[:2] for slots in SLOTS]
        for tile in grid:
            row = {"batch": b, "frames": n, "tile": tile, "plan": args.plan}
            for which, plan in (("seq_fwd", fwd_plan), ("seq_bwd", bwd_plan)):
                try:
                    row[f"{which}_plan"] = tk.serial_plan(which, spec, b, tile, plan)
                except RuntimeError as e:   # no plan: the block does not fit
                    row[f"{which}_plan"] = str(e)
            if not all(isinstance(row[f"{w}_plan"], dict)
                       for w in ("seq_fwd", "seq_bwd")):
                print(json.dumps(row))
                continue

            def fwd():
                return tk.seq_fwd_serial(spec, tw, xs, gc, st0, tile=tile,
                                         precision=prec, plan=fwd_plan)

            def bwd():
                return tk.seq_bwd(spec, tw, gc, ref[2], hprev, *cot, tile=tile,
                                  precision=prec, plan=bwd_plan)

            row["fwd_err"] = _max_err(f"seq_fwd {tile}", fwd(), ref[:4], FWD_TOL, prec)
            row["bwd_err"] = _max_err(f"seq_bwd {tile}", bwd(), bwd_ref, BWD_TOL, prec)
            row["serial_fwd_ms"] = _time_ms(fwd)
            row["bwd_ms"] = _time_ms(bwd)
            print(json.dumps(row))

        a = torch.nn.functional.leaky_relu(cs, 0.01).permute(1, 0, 2, 3).reshape(
            k, -1, spec.cond.cond_dim).contiguous()
        w_c = tw.w_ih_t[:, spec.z1_dim:].contiguous()
        bias = tw.b_ih[:, None, :].contiguous()
        with matmul_precision(prec):
            lib_ms = _time_ms(lambda: torch.baddbmm(bias, a, w_c))
        print(json.dumps({
            "cond_gates_ms": _time_ms(lambda: tk.cond_gates(spec, tw, cs, precision=prec)),
            "cublas_baddbmm_ms": lib_ms, "precision": prec, "batch": b, "frames": n}))
    return 0


def _plan_row(name, which, spec, b, plan, call, ref, tol, prec, timed) -> dict:
    """One plan of a serial kernel: its launch plan, its largest difference
    from the plain version and (``timed``) its ms by CUDA-graph replay, or
    why it does not take the spec."""
    try:
        row = {"plan": tk.serial_plan(which, spec, b, plan=plan)}
    except RuntimeError as e:
        return {"refused": str(e)}
    row["err"] = _max_err(name, call(), ref, tol, prec)
    if timed:
        row["ms"] = _time_ms(call)
    return row


def _rms(a, b) -> float:
    return (a.double() - b.double()).pow(2).mean().sqrt().item()


def _probe_gates() -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0]
    print(json.dumps({"card": card.strip(), "torch": torch.__version__}))
    paths = cuda_build.build(("cond_gates",))
    log = paths["cond_gates"].with_suffix(".log")
    for line in log.read_text().splitlines() if log.exists() else ():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(json.dumps({"ptxas": "cond_gates", "line": line.strip()}), flush=True)
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        hp = load_hparams(REPO / "hparams" / "final_model.yaml", dataset_root=tmp)
    spec = FlowSpec.build(hp)
    n = hp.Train["seq_len"] - spec.cond.longest_history
    model = seeded_random_model(spec, SEED).to(dev)
    g = torch.Generator(device=dev).manual_seed(SEED)
    failed = []
    with torch.no_grad():
        tw32 = tk.prepare_train_weights(spec, model.flow)
        tw64 = tk.TrainWeights(*(t.double() for t in tw32))
        for b in (hp.batch_size, 64):
            cs = torch.randn(n, spec.n_steps, b, spec.cond.cond_dim, generator=g,
                             device=dev)
            a = torch.nn.functional.leaky_relu(cs, 0.01).permute(1, 0, 2, 3).reshape(
                spec.n_steps, -1, spec.cond.cond_dim).contiguous()
            for prec in fk.MODES:
                mode = fk.MODES[prec]
                tw = tk.round_train_weights(tw32, mode)
                ref = tk.cond_gates_ref(spec, tw, cs, mode)
                row = {"precision": prec, "batch": b, "frames": n,
                       "launcher": tk.cond_gates_plan(mode)}
                if prec == "highest":
                    ref64 = tk.cond_gates_ref(spec, tw64, cs.double(), mode)
                    row["plain_rms_from_f64"] = _rms(ref, ref64)
                plans = [(f"simt{i}_k{bk}_s{st}", {"plan": "simt", "tile": i})
                         for i, (bk, st) in enumerate(tk.COND_GATES_TILES["simt"])]
                plans += [(f"tc{i}_{bm}x{bn}_w{wm}x{wn}_s{st}", {"plan": "tc", "tile": i})
                          for i, (bm, bn, wm, wn, st) in enumerate(tk.COND_GATES_TILES["tc"])]
                for plan, kw in plans:
                    def call(kw=kw):
                        return tk.cond_gates(spec, tw, cs, precision=prec, **kw)
                    try:
                        got = call()
                        row[f"{plan}_err"] = _max_err(plan, [got], [ref], FWD_TOL, prec)
                        if prec == "highest":
                            row[f"{plan}_rms_from_f64"] = _rms(got, ref64)
                        row[f"{plan}_ms"] = _time_ms(call)
                    except (RuntimeError, SystemExit) as e:
                        failed.append(f"{prec} B={b} {plan}: {e}")
                        row[f"{plan}_err"] = str(e)
                w_c = tw.w_ih_t[:, spec.z1_dim:].contiguous()
                bias = tw.b_ih[:, None, :].contiguous()
                with matmul_precision(prec):
                    row["cublas_baddbmm_ms"] = _time_ms(lambda: torch.baddbmm(bias, a, w_c))
                print(json.dumps(row), flush=True)
    if failed:
        raise SystemExit("failed: " + "; ".join(failed))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
