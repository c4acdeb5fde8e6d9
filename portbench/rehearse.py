"""A run of the harness on the CPU at a tiny scale, through the port's plain
paths, whole or with the timed path broken underneath it:

    python3 -m portbench.rehearse <cell>:<fault> [<cell>:<fault> ...]

prints each run's result (with `case`, and `forbidden`: the JAX modules
found loaded) as one JSON line. The faults:

- `none`: the port as it is;
- `control`: the control in the port's place (`run.py --control`);
- `altered_answer`: one row of each answer altered where the port makes
  it (`execute_local`);
- `half_left_out`: half of each answer's rows left out.

The CPU tests run it in a fresh process, so no module another test
loaded can meet the import guard.
"""
from __future__ import annotations

import json
import sys

from portbench import manifest, run, sut

# the tiny scale of each schema and caps the CPU can hold that fit it
SCALE = {"lubm": {"universities": 1}}
CPU_CAPS = {"scan_cap": 1 << 15, "out_cap": 1 << 15, "probe_cap": 64,
            "row_cap": 64}
FAULTS = ("none", "control", "altered_answer", "half_left_out")


def tiny_cell(name: str):
    cell = manifest.resolve(manifest.load_manifest(), name)
    cell.config.update(SCALE[cell.config["schema"]])
    cell.traffic.update(caps=CPU_CAPS, control_cap=100)
    return cell


def _first_half(valid, torch):
    """`valid` with its later half of true slots cleared (all of one)."""
    c = torch.cumsum(valid.to(torch.int64), -1)
    return valid & (c <= c[..., -1:] // 2)


def plant(fault: str):
    """Break the port's timed path underneath the harness; returns what
    mends it."""
    if fault in ("none", "control"):
        return lambda: None
    import torch
    sut.import_port()
    import repro_torch.core as core
    exec_local = core.execute_local

    def execute_local(*a, **k):
        bnd = exec_local(*a, **k)
        if fault == "altered_answer":
            bnd.table = bnd.table.clone()
            bnd.table[0, -1] += 1
        else:
            bnd.valid = _first_half(bnd.valid, torch)
        return bnd

    core.execute_local = execute_local

    def mend():
        core.execute_local = exec_local
    return mend


def rehearse(name: str, fault: str, seed: int = 2**31 + 11,
             seconds: float = 0.5) -> dict:
    if fault not in FAULTS:
        raise ValueError(f"fault must be one of {FAULTS}")
    mend = plant(fault)
    args = run.parse_args(["--workload", name, "--seed", str(seed),
                           "--seconds", str(seconds)])
    args.control = fault == "control"
    try:
        result = run.run(args, device="cpu", cell=tiny_cell(name))
    finally:
        mend()
    result["forbidden"] = run.forbidden_modules()
    return result


if __name__ == "__main__":
    # python3 -m portbench.rehearse <cell>:<fault> [<cell>:<fault> ...]
    for case in sys.argv[1:]:
        name, fault = case.split(":")
        print(json.dumps({"case": case, **rehearse(name, fault)}),
              flush=True)
