"""Hill-climb batch on the port's dry run: grok-1-314b train_4k and
olmoe-1b-7b train_4k, single pod, through ``repro_torch.launch.dryrun
.run_cell`` (the six cells of ``experiments/hillclimb_moe.py``).

Hypotheses (as the reference states them):
  grok  H1: per-microbatch passes dominate weight traffic; n_micro 8->2
            cuts re-reads/gathers ~4x while SP keeps activations inside
            HBM.
  grok  H2: expert capacity 1.25->1.0 trims the padded [E, C, d]
            dispatch pipeline ~20% (memory AND the TP collective bytes).
  olmoe H1: n_micro 4->1 (tiny model: activations fit) removes 3/4 of
            per-microbatch weight+dispatch traffic.
  olmoe H2: capacity 1.25->1.0, same reasoning as grok H2.

Each cell traces one train step on meta tensors over a fake 256-rank
process group (this process is its rank 0) and writes
experiments/perf_torch/<cell>.json.

Run: PYTHONPATH=src python experiments/hillclimb_moe_torch.py
"""
import sys

sys.path.insert(0, "src")

from repro_torch.launch.dryrun import run_cell  # noqa: E402

OUT = "experiments/perf_torch"

if __name__ == "__main__":
    run_cell("grok-1-314b", "train_4k", "single", OUT, tag="_base")
    run_cell("olmoe-1b-7b", "train_4k", "single", OUT, tag="_base")

    run_cell("grok-1-314b", "train_4k", "single", OUT,
             overrides={"n_micro": 2}, tag="_micro2")
    run_cell("grok-1-314b", "train_4k", "single", OUT,
             overrides={"n_micro": 2,
                        "cfg_replace": {"moe_capacity_factor": 1.0}},
             tag="_micro2_cap1")

    run_cell("olmoe-1b-7b", "train_4k", "single", OUT,
             overrides={"n_micro": 1}, tag="_micro1")
    run_cell("olmoe-1b-7b", "train_4k", "single", OUT,
             overrides={"n_micro": 1,
                        "cfg_replace": {"moe_capacity_factor": 1.0}},
             tag="_micro1_cap1")
