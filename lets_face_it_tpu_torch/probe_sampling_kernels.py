"""Probe of the sampling kernels' launch plan on one NVIDIA GPU.

    python -m lets_face_it_tpu_torch.probe_sampling_kernels [--quick]
        [--precision highest|high|medium] [--hidden_channels H]
        [--expression_dim E] [--n_steps K]
    python -m lets_face_it_tpu_torch.probe_sampling_kernels --gates
    python -m lets_face_it_tpu_torch.probe_sampling_kernels --plan hsplit
        [--hidden_channels H] [--expression_dim E] [--n_steps K]

For ``hparams/final_model.yaml`` (and ``no_face.yaml`` for P1 = 0) on
seeded random weights, or a wider spec of the search grid with
``--hidden_channels`` / ``--expression_dim`` / ``--n_steps`` (e.g. H = 512,
E = 48: C = 54 on 56 lanes, where the chain runs its hidden split; the
sweep of 3. then runs its streaming variant, ``--plan hsplit`` the split),
from the sources in this checkout:

1. builds the sampling kernels and prints the registers and spills
   ``nvcc -Xptxas -v`` reports for each;
2. holds ``sample_gates``, ``sample_chain``, ``frame_rev_fused`` and
   ``sequence_rev_fused`` against their plain versions with the launchers'
   own plans, at B = 1, 5, 33 and 128 (partial tiles and clusters; one frame
   atol 2e-4 / rtol 1e-4, sequences of 8 frames the same or 3 times the
   plain version's own float32 - float64 distance, whichever is larger,
   which it prints beside the kernels' at "highest");
3. unless ``--quick``: a device-time trace of one chain launch (where the
   plan holds the weights resident); for cluster sizes 4, 8 and 16, rows
   per tile 1, 2, 4 and 8, tiles per cluster (the plan's, 1, 2, 4) and, for
   the streaming variant at B = 1, ring slots (as many as fit, 2, 3, 4, 6,
   8), prints the chain's plan (placement, blocks, shared bytes, slots,
   clusters the device holds at once by
   ``cudaOccupancyMaxActiveClusters``), holds it against the plain version
   and times it by CUDA-graph replay at B = 1 and B = 128; then times
   ``sample_gates`` over rows per block and tile widths at B = 1, 64, 128
   and 512, beside ``cond_gates`` (the training GEMM) on the same
   conditioning product at N = 1.

``--gates`` runs only the gates' plans, at every matmul precision: at B =
1, 8, 16, 32, 64, 128 and 512, with the own face (two launches) and with
the projections given (one), the vector plan and each tile of the tile plan
(``flow_kernels.GATES_TILES``) held against the plain version at the
mode's limits and timed by CUDA-graph replay, beside the library call (the
three products as cuBLAS ``baddbmm`` at torch's same setting). The
launcher's threshold (``GATES_TILE_FROM_ROWS``) and default tile are read
from these rows: the least B from which a tile beats the vector plan at
every mode, and the tile that is fastest there.

``--plan hsplit`` runs only the chain's hidden split
(``csrc/sample_chain_hsplit.cuh``; the launcher's plan wherever no cluster
holds the weights, from H = 384 at the final widths, so pass
``--hidden_channels``): at B = 1 and 64, the
launcher's plan of the chain (whatever its placement) and ``frame_rev``
through the wrapper, held against their plain versions and timed; then the
hidden split over clusters 2-16 (those that split H), rows per tile (1 at
B = 1; 1, 2, 4 and 8 at B = 64) and ring slots (3, the launcher's, 2 and
4), each with its plan, held against the plain version and timed by
CUDA-graph replay; last ``seq_rev`` at B = 1 over 76 frames on the
launcher's plan, against its plain version (sequence limits as above) and
timed. With ``--quick`` the hidden split runs only in its cluster
(``flow_kernels.chain_hsplit_cluster``) on the launcher's tile and
``seq_rev`` is skipped: the launcher's plan against the hidden split where
the plan is another. Its weights' coupling heads are perturbed by 0.05 *
sqrt(128 / H) (``seeded_random_model(width_scaled_head=True)``: with 0.05
the random flow spreads float32 rounding past 2e-4 in one frame from
H = 2,048 at K = 16), and every check of this mode holds the kernel to the
plain version at max(2e-4, 3 times the plain version's own float32 -
float64 distance), both distances printed. The launcher's defaults
(``csrc/sample_chain.cuh::chain_hs_plan``,
``flow_kernels.chain_hsplit_cluster``) are read from these rows.

``--precision`` runs everything at that matmul precision (torch's ambient
setting, which the wrappers follow; the plain versions at the same mode;
the chain's trace stays at "highest", the only mode its instrumented
kernel has); at "high" and "medium" the checks hold the largest
|difference| to 4 steps of the mode's grid (2^-10 TF32, 2^-7 bf16) of the
output's largest |value|, as chip_smoke.py does.

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
from lets_face_it_tpu_torch.sample.weights import seeded_random_model
from lets_face_it_tpu_torch.utils.precision import matmul_precision
from lets_face_it_tpu_torch.utils.timing import cuda_time_ms, graphed

REPO = Path(__file__).resolve().parent.parent
SEED = 20240
ATOL, RTOL = 2e-4, 1e-4
# sequences: ATOL, or this times the plain version's own float32 - float64
# distance where the flow spreads rounding further (chip_smoke.py step 18's)
SEQ_RATIO = 3.0
# at a reduced precision: steps of its grid, of the output's largest |value|
MODE_GRID, MODE_STEPS = {"high": 2.0 ** -10, "medium": 2.0 ** -7}, 4.0
CHECK_BATCHES = (1, 5, 33, 128)
CLUSTERS = (4, 8, 16)
ROWS_PER_TILE = (1, 2, 4, 8)
TILES_PER_CLUSTER = (0, 1, 2, 4)   # 0: the plan's
RING_SLOTS = (0, 2, 3, 4, 6, 8)    # 0: as many as fit
GATE_BATCHES = (1, 64, 128, 512)
GATE_ROWS = (0, 1, 2, 4, 8, 16)    # 0: the launcher's
GATE_GROUPS = (0, 8, 32)           # 0: the launcher's
PLAN_BATCHES = (1, 8, 16, 32, 64, 128, 512)
HSPLIT_BATCHES = (1, 64)
HSPLIT_SLOTS = (0, 2, 4)           # 0: the launcher's (3)


def _time_ms(fn, reps=20):
    """Mean ms per replay of ``fn`` captured in a CUDA graph (CUDA events;
    one call before the capture, one replay before the timed ones)."""
    return cuda_time_ms(graphed(fn, warmup=1), reps, warmup=1)


def _max_err(name, got, ref, atol=ATOL):
    worst = 0.0
    prec = fk.ambient_matmul_precision()
    for i, (a, r) in enumerate(zip(got, ref)):
        if r is None:
            continue
        rtol = RTOL
        if prec != "highest":
            atol = MODE_STEPS * MODE_GRID[prec] * max(r.abs().max().item(), 1.0)
            rtol = 0.0
        err = (a.double() - r.double()).abs()
        if not torch.isfinite(a).all() or (err > atol + rtol * r.double().abs()).any():
            raise SystemExit(f"{name} output {i}: max|diff| {err.max().item():.3e} "
                             f"exceeds atol {atol} + rtol {rtol}*|ref|")
        worst = max(worst, err.max().item())
    return worst


def widened(hp, hidden_channels=None, expression_dim=None, n_steps=None):
    """``hp`` at a wider spec of the search grid (hparam_tuning_configs/
    large_hparam_search.py's names), the face dims following the expression
    dim as the search keeps them."""
    if hidden_channels:
        hp.Glow["hidden_channels"] = hidden_channels
    if n_steps:
        hp.Glow["K"] = n_steps
    if expression_dim:
        hp.Data["expression_dim"] = expression_dim
        c = expression_dim + hp.Data["jaw_dim"] + hp.Data["neck_dim"]
        hp.Conditioning["p1_face"]["dim"] = hp.Conditioning["p2_face"]["dim"] = c
    return hp


def _dist(a, b) -> float:
    return (a.double() - b.double()).abs().max().item()


class _Case:
    """One config's weights and a frame's inputs at batch b."""

    def __init__(self, name, dev, tmp, wide=None, scaled_head=False):
        hp = widened(load_hparams(REPO / "hparams" / f"{name}.yaml", dataset_root=tmp),
                     **(wide or {}))
        # the single kernels' wrappers take the kernels' lanes: a model of
        # their width (C = 54 runs on 56)
        self.spec = spec = fk.kernel_spec(FlowSpec.build(hp))
        model = seeded_random_model(spec, SEED, width_scaled_head=scaled_head).to(dev)
        self.p1 = p1 = spec.cond.p1_face.out_dim
        # float32, and rounded once for the ambient precision as the owners
        # of sampling weights hold them
        self.w32 = fk.prepare_sampling_weights(spec, model.flow)
        self.w = fk.round_sampling_weights(spec, self.w32, fk.precision_mode())
        self.w64 = self.w32._replace(**{n: t.double() for n, t in
                                        self.w32._asdict().items() if n != "mode"})
        self.w_p1_t = model.flow["cond_proj"]["w"][:, :, :p1].transpose(1, 2) \
            .contiguous().detach()
        self.tw = tk.prepare_train_weights(spec, model.flow)
        self.g = torch.Generator(device=dev).manual_seed(SEED)
        self.dev = dev

    def randn(self, *shape, scale=1.0):
        return scale * torch.randn(shape, generator=self.g, device=self.dev)

    def frame(self, b):
        s = self.spec
        k, c, h, cond = s.n_steps, s.channels, s.hidden_channels, s.cond.cond_dim
        return (self.randn(b, c), self.randn(k, b, cond), self.randn(b, self.p1),
                self.randn(k, b, h, scale=0.5))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--quick", action="store_true")
    parser.add_argument("--precision", default="highest", choices=tuple(fk.MODES))
    parser.add_argument("--gates", action="store_true",
                        help="only the gates' plans, at every precision")
    parser.add_argument("--hidden_channels", type=int, default=None)
    parser.add_argument("--expression_dim", type=int, default=None)
    parser.add_argument("--n_steps", type=int, default=None, help="flow steps K")
    parser.add_argument("--plan", choices=("hsplit",), default=None,
                        help="only the chain's hidden split")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("this probe needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.gates:
        return _probe_gates()
    wide = {"hidden_channels": args.hidden_channels,
            "expression_dim": args.expression_dim, "n_steps": args.n_steps}
    with matmul_precision(args.precision):
        if args.plan == "hsplit":
            return _probe_hsplit(wide, args.quick)
        return _probe(args.quick, wide)


def _card_line():
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0]
    print(json.dumps({"card": card.strip(), "torch": torch.__version__,
                      "precision": fk.ambient_matmul_precision()}), flush=True)


def _ptxas_lines(names):
    """Builds the libraries ``names``; prints nvcc's register and spill
    report of each."""
    paths = cuda_build.build(names)
    for name, path in paths.items():
        log = path.with_suffix(".log")
        for line in log.read_text().splitlines() if log.exists() else ():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(json.dumps({"ptxas": name, "line": line.strip()}), flush=True)


def _probe_hsplit(wide: dict, quick: bool) -> int:
    mode = fk.precision_mode(None)
    _card_line()
    _ptxas_lines(("sample_gates", "sample_chain", "frame_rev", "seq_rev"))
    dev = torch.device("cuda")
    failed = []
    with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
        case = _Case("final_model", dev, tmp, wide, scaled_head=True)
        spec, w = case.spec, case.w
        h = spec.hidden_channels
        print(json.dumps({"spec": {"C": spec.channels, "K": spec.n_steps, "H": h,
                                   "cond": spec.cond.cond_dim},
                          "chain_placement": fk.chain_placement(spec)}), flush=True)
        d = lambda t: t.double()  # noqa: E731
        for b in HSPLIT_BATCHES:
            z, fixed, hist, st = case.frame(b)
            _, gc, gh = fk.sample_gates(spec, w, case.w_p1_t, fixed, hist, st)
            ref = fk.sample_chain_ref(spec, w, z, gc, gh, st, hist, mode)
            chain = lambda: fk.sample_chain(spec, w, z, gc, gh, st, hist)  # noqa: E731
            frame = lambda: fk.frame_rev_fused(spec, w, z, fixed, st)  # noqa: E731
            frame_ref = fk.frame_rev_fused_ref(spec, w, z, fixed, st, mode)
            row = {"batch": b, "launcher_plan": fk.chain_plan(spec, b)}
            # the plain versions' own float32 - float64 distance (at
            # "highest"): a wide random flow spreads rounding by itself
            own = {"chain": 0.0, "frame_rev": 0.0}
            if mode == 0:
                chain64 = fk.sample_chain_ref(spec, case.w64, d(z), d(gc), d(gh), d(st),
                                              d(hist))
                frame64 = fk.frame_rev_fused_ref(spec, case.w64, d(z), d(fixed), d(st))
                own = {"chain": _dist(ref[0], chain64[0]),
                       "frame_rev": _dist(frame_ref[0], frame64[0])}
                row["kernel_from_float64"] = {"chain": _dist(chain()[0], chain64[0]),
                                              "frame_rev": _dist(frame()[0], frame64[0])}
                row["plain_from_float64"] = own
            for name, call, r in (("chain", chain, ref), ("frame_rev", frame, frame_ref)):
                try:
                    row[f"{name}_err"] = _max_err(name, call(), r,
                                                  max(ATOL, SEQ_RATIO * own[name]))
                except SystemExit as e:
                    failed.append(f"B={b} {name}: {e}")
                    row[f"{name}_err"] = str(e)
                row[f"{name}_ms"] = _time_ms(call)
            print(json.dumps(row), flush=True)
            clusters = (fk.chain_hsplit_cluster(spec),) if quick else fk.HSPLIT_CLUSTERS
            for cs_n in clusters:
                if not fk.hsplit_cluster_ok(h, cs_n):
                    continue
                wl = fk._laid_out_for(spec, w, cs_n)
                for bt in (0,) if quick else ROWS_PER_TILE if b > 1 else (1,):
                    for sl in (0,) if quick else HSPLIT_SLOTS:
                        tile = (bt, cs_n, 0, sl)
                        row = {"batch": b, "hsplit_tile": tile}
                        try:
                            row["plan"] = fk.chain_plan(spec, b, tile, hsplit=True)
                        except RuntimeError as e:   # the block does not fit
                            row["plan"] = str(e)
                            print(json.dumps(row), flush=True)
                            continue

                        def run(tile=tile):
                            return fk.sample_chain(spec, wl, z, gc, gh, st, hist,
                                                   tile=tile, hsplit=True)

                        try:
                            row["err"] = _max_err(f"hsplit {tile}", run(), ref,
                                                  max(ATOL, SEQ_RATIO * own["chain"]))
                        except SystemExit as e:
                            failed.append(f"B={b} {tile}: {e}")
                            row["err"] = str(e)
                        row["ms"] = _time_ms(run)
                        print(json.dumps(row), flush=True)
                del wl
        if quick:
            return _failed(failed)
        n_seq = 76
        zs = case.randn(n_seq, 1, spec.channels)
        fx = case.randn(n_seq, spec.n_steps, 1, spec.cond.cond_dim)
        _, _, hist, st = case.frame(1)
        seq = lambda: fk.sequence_rev_fused(spec, w, case.w_p1_t, zs, fx, hist, st)  # noqa: E731
        seq_ref = fk.sequence_rev_fused_ref(spec, w, case.w_p1_t, zs, fx, hist, st, mode)
        drift = 0.0
        if mode == 0:
            drift = _dist(seq_ref, fk.sequence_rev_fused_ref(
                spec, case.w64, d(case.w_p1_t), d(zs), d(fx), d(hist), d(st)))
        try:
            err = _max_err("seq_rev", [seq()], [seq_ref], max(ATOL, SEQ_RATIO * drift))
        except SystemExit as e:
            failed.append(str(e))
            err = str(e)
        print(json.dumps({"seq_rev": {"batch": 1, "frames": n_seq, "max_abs_err": err,
                                      "plain_f64_distance": drift,
                                      "first_8_frames_err": _dist(seq()[:8], seq_ref[:8]),
                                      "ms": _time_ms(seq, reps=3)}}), flush=True)
    return _failed(failed)


def _failed(failed) -> int:
    if failed:
        raise SystemExit("failed: " + "; ".join(failed))
    return 0


def _library_gates(spec, w, w_p1_t, fixed, hist, states):
    """The gates as three cuBLAS products (chip_smoke.py's yardstick)."""
    proj = fixed
    if hist.shape[-1]:
        proj = torch.baddbmm(fixed, hist.expand(spec.n_steps, -1, -1), w_p1_t)
    gc = torch.baddbmm(w.b_ih[:, None], torch.nn.functional.leaky_relu(proj, 0.01),
                       w.w_ih_t[:, spec.z1_dim:])
    return proj, gc, torch.baddbmm(w.b_hh[:, None], states, w.w_hh_t)


def _probe_gates() -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0]
    print(json.dumps({"card": card.strip(), "torch": torch.__version__}))
    paths = cuda_build.build(("sample_gates",))
    log = paths["sample_gates"].with_suffix(".log")
    for line in log.read_text().splitlines() if log.exists() else ():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            print(json.dumps({"ptxas": "sample_gates", "line": line.strip()}), flush=True)
    dev = torch.device("cuda")
    failed = []
    plans = [("vector", {"plan": "vector"})] + [
        (f"tile{i}_{bm}x{bn}_w{wm}x{wn}_s{st}", {"plan": "tile", "tile": i})
        for i, (bm, bn, wm, wn, st) in enumerate(fk.GATES_TILES)]
    with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
        case = _Case("final_model", dev, tmp)
        spec = case.spec
        for prec in fk.MODES:
            with matmul_precision(prec):
                mode = fk.precision_mode()
                w = fk.round_sampling_weights(spec, case.w32, mode)
                for b in PLAN_BATCHES:
                    z, fixed, hist, st = case.frame(b)
                    for own in (True, False):
                        p1 = case.p1 if own else 0
                        args = (spec, w, case.w_p1_t[:, :p1], fixed, hist[:, :p1], st)
                        ref = fk.sample_gates_ref(*args, mode)
                        row = {"precision": prec, "batch": b, "own_face": own,
                               "launcher": fk.gates_plan(b, mode=mode)}
                        for label, kw in plans:
                            try:
                                row[f"{label}_err"] = _max_err(
                                    label, fk.sample_gates(*args, **kw), ref)
                                row[f"{label}_ms"] = _time_ms(
                                    lambda kw=kw: fk.sample_gates(*args, **kw))
                            except (RuntimeError, SystemExit) as e:
                                failed.append(f"{prec} B={b} own={own} {label}: {e}")
                                row[f"{label}_err"] = str(e)
                        row["library_ms"] = _time_ms(lambda: _library_gates(
                            spec, case.w32, case.w_p1_t[:, :p1], fixed, hist[:, :p1], st))
                        print(json.dumps(row), flush=True)
    if failed:
        raise SystemExit("failed: " + "; ".join(failed))
    return 0


def _probe(quick: bool, wide: dict) -> int:
    mode = fk.precision_mode(None)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0]
    print(json.dumps({"card": card.strip(), "torch": torch.__version__,
                      "precision": fk.ambient_matmul_precision()}))

    paths = cuda_build.build(("sample_gates", "sample_chain", "frame_rev", "seq_rev",
                              "cond_gates"))
    for name, path in paths.items():
        log = path.with_suffix(".log")
        for line in log.read_text().splitlines() if log.exists() else ():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(json.dumps({"ptxas": name, "line": line.strip()}), flush=True)

    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp, torch.no_grad():
        cases = {n: _Case(n, dev, tmp, wide) for n in ("final_model", "no_face")}
        s0 = cases["final_model"].spec
        print(json.dumps({"spec": {"C": s0.channels, "K": s0.n_steps,
                                   "H": s0.hidden_channels, "cond": s0.cond.cond_dim},
                          "chain_placement": fk.chain_placement(s0)}), flush=True)
        failed = []

        def attempt(label, fn):
            """fn's reading, or its failure recorded (every check runs)."""
            try:
                return fn()
            except (RuntimeError, SystemExit) as e:
                failed.append(f"{label}: {e}")
                return str(e)

        for name, cs_ in cases.items():
            spec, w = cs_.spec, cs_.w
            for b in CHECK_BATCHES:
                z, fixed, hist, st = cs_.frame(b)
                zs = cs_.randn(8, b, spec.channels)
                fx = cs_.randn(8, spec.n_steps, b, spec.cond.cond_dim)
                gates = fk.sample_gates_ref(spec, w, cs_.w_p1_t, fixed, hist, st, mode)
                _, gc, gh = gates
                # the plain versions in float32 and float64 (at "highest"):
                # how far the flow spreads float32 rounding by itself
                seq_ref = fk.sequence_rev_fused_ref(spec, w, cs_.w_p1_t, zs, fx, hist,
                                                    st, mode)
                drift = {"seq_rev_plain": 0.0}
                if mode == 0:
                    w64, d = cs_.w64, lambda t: t.double()
                    seq64 = fk.sequence_rev_fused_ref(spec, w64, d(cs_.w_p1_t), d(zs),
                                                      d(fx), d(hist), d(st))
                    chain64 = fk.sample_chain_ref(spec, w64, d(z), d(gc), d(gh), d(st),
                                                  d(hist))[0]
                    got = fk.sample_chain(spec, w, z, gc, gh, st, hist)[0]
                    ref = fk.sample_chain_ref(spec, w, z, gc, gh, st, hist)[0]
                    drift = {"seq_rev_plain": _dist(seq_ref, seq64),
                             "seq_rev_kernel": _dist(fk.sequence_rev_fused(
                                 spec, w, cs_.w_p1_t, zs, fx, hist, st), seq64),
                             "chain_plain": _dist(ref, chain64),
                             "chain_kernel": _dist(got, chain64)}
                errs = {
                    "sample_gates": attempt(f"{name} sample_gates B={b}", lambda: _max_err(
                        "", fk.sample_gates(spec, w, cs_.w_p1_t, fixed, hist, st), gates)),
                    "sample_chain": attempt(f"{name} sample_chain B={b}", lambda: _max_err(
                        "", fk.sample_chain(spec, w, z, gc, gh, st, hist),
                        fk.sample_chain_ref(spec, w, z, gc, gh, st, hist, mode))),
                    "frame_rev": attempt(f"{name} frame_rev B={b}", lambda: _max_err(
                        "", fk.frame_rev_fused(spec, w, z, fixed, st),
                        fk.frame_rev_fused_ref(spec, w, z, fixed, st, mode))),
                    "seq_rev": attempt(f"{name} seq_rev B={b} N=8", lambda: _max_err(
                        "", [fk.sequence_rev_fused(spec, w, cs_.w_p1_t, zs, fx, hist, st)],
                        [seq_ref], max(ATOL, SEQ_RATIO * drift["seq_rev_plain"])))}
                torch.cuda.synchronize()
                print(json.dumps({"check": name, "batch": b,
                                  "chain_plan": attempt("plan", lambda: fk.chain_plan(spec, b)),
                                  "max_abs_err": errs, "from_float64": drift}), flush=True)
        if failed:
            raise SystemExit("failed: " + "; ".join(failed))
        if quick:
            return 0

        case = cases["final_model"]
        spec, w = case.spec, case.w
        n_seq = 76
        resident = fk.chain_resident(spec)
        for b in (1, 128):
            # where a chain launch's time goes: each block's device times of
            # the first tile, in us after the earliest block start (the
            # traced kernel is the resident variant's)
            z, fixed, hist, st = case.frame(b)
            _, gc, gh = fk.sample_gates(spec, w, case.w_p1_t, fixed, hist, st)
            for tile in ((0, 0, 0), (0, 16, 0)) if resident else ():
                plan = fk.chain_plan(spec, b, tile)
                trace = torch.zeros(plan["blocks"], fk.CHAIN_TRACE_SLOTS,
                                    dtype=torch.int64, device=dev)
                for _ in range(3):   # the last of three launches
                    fk.sample_chain(spec, case.w32, z, gc, gh, st, hist, tile=tile,
                                    trace=trace, precision="highest")
                torch.cuda.synchronize()
                t = trace[:plan["cluster"]].cpu()
                held = -(-spec.n_steps // plan["cluster"])
                t0 = t[:, 0].min().item()
                print(json.dumps({"trace": {
                    "batch": b, "plan": plan,
                    "us_after_start": [[round((v - t0) / 1e3, 3)
                                        for v in row[:4 + held].tolist() if v]
                                       for row in t],
                    "first_step_gru_coupling_end": [[round((v - t0) / 1e3, 3)
                                                     for v in row[-2:].tolist()]
                                                    for row in t],
                    "sm_ghz_first_step": [round((row[-3] - row[-4]).item()
                                                / (row[3] - row[2]).item(), 3)
                                          for row in t]}}), flush=True)
            zs = case.randn(n_seq, b, spec.channels)
            fx = case.randn(n_seq, spec.n_steps, b, spec.cond.cond_dim)
            print(json.dumps({
                "batch": b, "chain_plan": fk.chain_plan(spec, b), "frame_rev_ms": _time_ms(
                    lambda: fk.frame_rev_fused(spec, w, z, fixed, st)),
                "seq_rev_ms": _time_ms(lambda: fk.sequence_rev_fused(
                    spec, w, case.w_p1_t, zs, fx, hist, st), reps=3),
                "frames": n_seq}), flush=True)

        for b in (1, 128):
            z, fixed, hist, st = case.frame(b)
            _, gc, gh = fk.sample_gates(spec, w, case.w_p1_t, fixed, hist, st)
            ref = fk.sample_chain_ref(spec, w, z, gc, gh, st, hist, mode)
            # the plan's placement; at B = 1 a resident spec forced to the
            # streaming variant too; where the plan is the hidden split
            # (swept by --plan hsplit), the streaming variant
            places = ((None, False) if resident and b == 1
                      else (False,) if fk.chain_hsplit(spec) else (None,))
            for place in places:
                streamed = place is False or not resident
                tiles = [(bt, cs_n, m, sl) for cs_n in CLUSTERS
                         for bt in (ROWS_PER_TILE if b > 1 else (1,))
                         for m in (TILES_PER_CLUSTER if b > 1 else (1,))
                         for sl in (RING_SLOTS if b == 1 and streamed else (0,))]
                for tile in tiles:
                    row = {"batch": b, "tile": tile, "resident": place}
                    try:
                        row["plan"] = fk.chain_plan(spec, b, tile, resident=place)
                    except RuntimeError as e:   # no plan: the block does not fit
                        row["plan"] = str(e)
                        print(json.dumps(row), flush=True)
                        continue

                    def run(tile=tile, place=place):
                        return fk.sample_chain(spec, w, z, gc, gh, st, hist,
                                               tile=tile, resident=place)

                    row["err"] = _max_err(f"sample_chain {tile}", run(), ref)
                    row["ms"] = _time_ms(run)
                    print(json.dumps(row), flush=True)

        for b in GATE_BATCHES:
            z, fixed, hist, st = case.frame(b)
            row = {"batch": b}
            for rows in GATE_ROWS:
                for groups in GATE_GROUPS:
                    row[f"sample_gates_rows{rows}_groups{groups}_ms"] = _time_ms(
                        lambda: fk.sample_gates(spec, w, case.w_p1_t, fixed, hist, st,
                                                rows=rows, groups=groups))
            # the conditioning product alone: sample_gates with P1 = 0 runs
            # gc and gh in one launch; cond_gates (N = 1) runs gc only
            empty_hist, empty_w = hist[:, :0], case.w_p1_t[:, :0]
            nf = cases["no_face"]
            row["sample_gates_gc_gh_ms"] = _time_ms(
                lambda: fk.sample_gates(nf.spec, nf.w, empty_w, fixed, empty_hist, st))
            row["cond_gates_gc_ms"] = _time_ms(
                lambda: tk.cond_gates(spec, case.tw, fixed[None]))
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
