"""Reproduce the paper's headline comparison (Table II / Fig. 3a) on the
PyTorch/CUDA port: ``examples/paper_reproduction.py`` on ``repro_torch``.

Runs FedHAP-oneHAP, FedHAP-GS and the baselines on the same constellation
and prints accuracy-vs-simulated-hours curves side by side. It runs on the
card; ``--cpu`` runs it on the CPU (without a card and without ``--cpu``
it raises).

  PYTHONPATH=src python examples/paper_reproduction_torch.py          # quick
  PYTHONPATH=src python examples/paper_reproduction_torch.py --full   # paper scale
"""
import argparse
import json
import pathlib

from repro_torch.launch import table2


def main(argv=None, **overrides) -> list[dict]:
    """The CLI; ``overrides`` replace fields of every row's ``SimConfig``
    (the tests shrink it). Returns the rows."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--methods", default=None,
                    help="comma list of Table II rows to run")
    ap.add_argument("--out", default="runs/paper_reproduction_torch.json")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    methods = args.methods.split(",") if args.methods else None
    rows = table2.run(quick=not args.full, methods=methods,
                      device="cpu" if args.cpu else "cuda", **overrides)

    print("\n=== Table II reproduction ===")
    print(f"{'method':<18} {'accuracy':>9} {'rounds':>7} {'sim hours':>10}")
    for r in rows:
        print(f"{r['method']:<18} {r['final_acc']:>9.4f} "
              f"{r['rounds']:>7d} {r['sim_hours']:>10.2f}")
    ordered = sorted(rows, key=lambda r: -r["final_acc"])
    print(f"\nbest: {ordered[0]['method']} @ {ordered[0]['final_acc']:.4f}")
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(rows, indent=1))
    print(f"histories written to {args.out}")
    return rows


if __name__ == "__main__":
    main()
