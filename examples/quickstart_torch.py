"""Quickstart on the PyTorch/CUDA port: FedHAP in ~40 lines.

Trains the paper's MLP across a 3-orbit constellation orchestrated by one
HAP, printing accuracy vs simulated hours — ``examples/quickstart.py``
on ``repro_torch``. It runs on the card; ``--cpu`` runs it on the CPU.

  PYTHONPATH=src python examples/quickstart_torch.py [--cpu] [--sampled]

Pass ``--sampled`` to multiplex 480 virtual ground clients onto the 12
satellites with 30% per-round participation (``SimConfig.clients``, see
``repro_torch.clients``) instead of the default one-static-shard-per-
satellite plane — same constellation, same strategy, drifting per-round
cohorts.
"""
import sys

from repro_torch.sim import SatcomSimulator, SimConfig


def main(sampled: bool = False, device: str = "cuda", **overrides) -> None:
    """Build and run the quickstart config on ``device``; ``overrides``
    replace any of its ``SimConfig`` fields (the tests shrink it)."""
    cfg = SimConfig(**{**dict(
        strategy="fedhap",        # the paper's algorithm
        stations="one_hap",       # HAP above Rolla, MO (paper §IV-A)
        model_kind="mlp",
        iid=False,                # paper's non-IID orbit split
        num_orbits=3,
        sats_per_orbit=4,
        num_samples=6000,
        eval_samples=1200,
        local_steps=12,
        max_rounds=6,
        horizon_h=48.0,
        time_step_s=60.0,
        # Virtual-client plane: 480 ground clients, Dirichlet(0.5)
        # label skew, 30% sampled per round with a deterministic
        # per-round stream ("static" keeps the seed behaviour).
        clients="sampled:0.3x480" if sampled else "static",
        client_partitioner="dirichlet:0.5" if sampled else "iid",
        device=device,            # the card unless the caller asks
    ), **overrides})
    sim = SatcomSimulator(cfg)
    print(f"constellation: {cfg.num_orbits} orbits x {cfg.sats_per_orbit} "
          f"satellites, PS: {sim.stations[0].name}, device {sim.device}")
    print(f"model: paper MLP ({sim.trainer.model.count_params():,} params)")
    print(f"client plane: {sim.client_plane.describe()}")
    result = sim.run()
    print("\nsim_hours  round  accuracy")
    for t, r, a in result.history:
        print(f"{t:9.2f}  {r:5d}  {a:.4f}")
    print(f"\nfinal accuracy {result.final_accuracy:.4f} after "
          f"{result.rounds} rounds / {result.sim_hours:.1f} simulated h")


if __name__ == "__main__":
    main(sampled="--sampled" in sys.argv[1:],
         device="cpu" if "--cpu" in sys.argv[1:] else "cuda")
