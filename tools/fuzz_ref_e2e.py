"""End-to-end fuzz vs the reference binary: random read sets on the
bundled yeast genome, byte-compared in both output modes.

Each iteration simulates a fresh read set (mixed lengths, occasional
structural-variant reads that force large-tile escalation), runs the
COMPLETE reference binary (tests/ref_binary.py shim build) and this
framework's CLI under the same cwd/params.cfg, and asserts identical
stdout.  Our side runs the production fused dispatch rounds (speculative
chains, compact records, wide reruns) on whatever device JAX runs on.

Usage:
    JAX_PLATFORMS=cpu python tools/fuzz_ref_e2e.py \
        [--iters 20] [--mode both] [--scoring default|generic]
        [--seed0 1000] [--workdir /tmp/fuzz_ref]

Prints one JSON line; exit 0 = every iteration byte-identical.
Mismatching artifacts are left in the workdir for diagnosis.
"""

import argparse
import json
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))


import numpy as np  # noqa: E402

REF = "/root/reference/software/data/sample_ref.fa"


def _write_fa(path, reads):
    with open(path, "w") as f:
        for name, seq in reads:
            f.write(f">{name}\n{bytes(np.asarray(seq, np.uint8)).decode()}\n")


def _our_cli(ref_path, reads_path, overlap, cwd):
    import contextlib
    import io

    from darwin_tpu import cli
    old = os.getcwd()
    buf = io.StringIO()
    try:
        os.chdir(cwd)
        with contextlib.redirect_stdout(buf), \
                contextlib.redirect_stderr(io.StringIO()):
            rc = cli.main([str(ref_path), str(reads_path),
                           "1" if overlap else "0"])
    finally:
        os.chdir(old)
    if rc != 0:
        raise RuntimeError(f"cli rc={rc}")
    return buf.getvalue()


def _make_reads(store, rng):
    from darwin_tpu.utils.simulate import simulate_reads
    n = int(rng.integers(6, 14))
    reads = []
    seed = int(rng.integers(0, 2**31))
    lengths = rng.integers(600, 9000, size=n)
    for i, (nm, s, _) in enumerate(
            simulate_reads(store, n, int(lengths.max()), seed=seed,
                           error=(0.04, 0.03, 0.03))):
        reads.append((f"r{i}_{nm}", s[:int(lengths[i])]))
    # SV reads force 1984-wide large-tile escalation
    if rng.random() < 0.5:
        s0 = int(store.chromosomes[0].start) + int(rng.integers(0, 150000))
        left = int(rng.integers(1200, 2500))
        gap = int(rng.integers(600, 1500))
        seq = np.concatenate([store.bases[s0:s0 + left],
                              store.bases[s0 + left + gap:
                                          s0 + left + gap + left]]).copy()
        idx = rng.integers(0, len(seq), size=len(seq) // 50)
        seq[idx] = np.frombuffer(b"ACGT", np.uint8)[
            rng.integers(0, 4, len(idx))]
        reads.append(("sv", seq))
    return reads


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--mode", choices=("sam", "mhap", "both"),
                    default="both")
    ap.add_argument("--seed0", type=int, default=1000)
    ap.add_argument("--scoring", choices=("default", "generic"),
                    default="default",
                    help="generic = opening cheaper than extending (both "
                         "gap lanes).  The reference kernel TRUNCATES gap "
                         "re-opening chains there (lazy-loop early exit, "
                         "tests/test_ref_parity.py GENERIC_SCORINGS note), "
                         "so the baseline switches from the reference "
                         "binary to our own pipeline without speculation "
                         "(SPEC_K = 1): the run checks that the "
                         "speculative fused rounds reproduce it "
                         "byte-for-byte under the generic scan")
    ap.add_argument("--workdir", default="/tmp/fuzz_ref")
    args = ap.parse_args()

    import ref_binary as rb
    from darwin_tpu.io.fasta import load_genome
    from darwin_tpu.ops import dispatch

    spec_k = dispatch.SPEC_K

    def with_spec(k):
        dispatch.SPEC_K = k

    if args.scoring != "generic":
        rb.build()
    store = load_genome(REF)
    os.makedirs(args.workdir, exist_ok=True)
    import re
    cfg_text = open("/root/reference/software/params.cfg").read()
    if args.scoring == "generic":
        for key, val in (("gap_open", "-1"), ("gap_extend", "-5"),
                         ("long_gap_open", "-3"),
                         ("long_gap_extend", "-9")):
            cfg_text = re.sub(rf"(?m)^{key}\s*=.*$", f"{key} = {val}",
                              cfg_text)
    open(os.path.join(args.workdir, "params.cfg"), "w").write(cfg_text)

    from darwin_tpu.config import load_config
    from darwin_tpu.utils.rescore import classify_mhap, classify_sam
    cfg = load_config(os.path.join(args.workdir, "params.cfg"))

    t0 = time.time()
    done = 0
    ties = 0
    cascades = 0
    for it in range(args.iters):
        rng = np.random.default_rng(args.seed0 + it)
        reads = _make_reads(store, rng)
        fa = os.path.join(args.workdir, f"reads_{it}.fa")
        _write_fa(fa, reads)
        modes = {"sam": [False], "mhap": [True],
                 "both": [False, True]}[args.mode]
        for overlap in modes:
            if args.scoring == "generic":
                # baseline = our own pipeline without speculation (see
                # --scoring help)
                with_spec(1)
                ref_out = _our_cli(REF, fa, overlap, args.workdir)
                with_spec(spec_k)
                our_out = _our_cli(REF, fa, overlap, args.workdir)
            else:
                ref_out = rb.run(REF, fa, overlap, args.workdir)
                our_out = _our_cli(REF, fa, overlap, args.workdir)
            if ref_out == our_out:
                continue
            if args.scoring == "generic":
                # our own two pipelines must agree EXACTLY — the
                # stripe-tie rationale applies only vs the reference
                cls = {"hard": [("spec on/off differ", "")],
                       "tie_equivalent": 0}
            else:
                # adjudicate: the reference's stripe-geometry tie-breaks
                # can pick a different EQUAL-SCORE path
                # (utils/rescore.py); only a divergence that fails
                # rescoring is a bug
                cls = (classify_mhap(ref_out, our_out, cfg) if overlap
                       else classify_sam(ref_out, our_out, REF, cfg))
            if cls["hard"] and args.scoring == "default":
                # last adjudication level: an equal-score tile tie can
                # send the greedy tiling down a different route whose
                # FINAL score differs (tie cascade).  Replay every tile
                # this read set issued against the reference kernel; the
                # divergence is legitimate iff all tiles are exact or
                # pinned ties (tools/tile_audit.py)
                sys.path.insert(0, os.path.dirname(
                    os.path.abspath(__file__)))
                import tile_audit
                aud = tile_audit.audit(REF, fa, cfg, do_overlap=overlap)
                print(f"iter {it}: output diverged; tile audit: {aud}",
                      file=sys.stderr)
                if aud["hard"] == 0 and aud["tie"] > 0:
                    cascades += 1
                    cls = {"hard": [], "tie_equivalent": 0}
            if cls["hard"]:
                tag = f"{it}_{'mhap' if overlap else 'sam'}"
                open(os.path.join(args.workdir, f"ref_{tag}.out"),
                     "w").write(ref_out)
                open(os.path.join(args.workdir, f"our_{tag}.out"),
                     "w").write(our_out)
                print(json.dumps({
                    "ok": False, "iter": it, "mode": tag,
                    "spec_k": spec_k, "reads_fa": fa,
                    "hard_mismatches": len(cls["hard"]),
                    "workdir": args.workdir}))
                return 1
            ties += cls["tie_equivalent"]
            print(f"iter {it}: {cls['tie_equivalent']} tie-equivalent "
                  f"line(s), rescored equal", file=sys.stderr)
        os.remove(fa)
        done += 1
        print(f"iter {it} ok ({time.time() - t0:.0f}s)", file=sys.stderr)
    print(json.dumps({"ok": True, "iters": done, "mode": args.mode,
                      "spec_k": spec_k, "scoring": args.scoring,
                      "tie_equivalent_lines": ties,
                      "tie_cascades": cascades,
                      "seconds": round(time.time() - t0, 1)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
