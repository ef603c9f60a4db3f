"""The two readings each ``correct`` limit is set from, on the card:

* the program's: one request of the cell (the window's first request,
  at the cell's size) on each seed, against the plain reference;
* the control's: the reference computed with every stage rounded to
  bfloat16, put in the program's place, on each control seed.

    python3 portbench/readings.py --workload <name> --seeds 1,2,3
        [--control-seeds 1,2,3]

Prints one JSON line a reading and, last, the largest program reading
and the smallest control reading of each number.  The benchmark's runs
do not run this."""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    a = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench.harness import manifest, mrcfile
    from portbench.harness.cell import Requests
    from portbench.traffic import phantoms
    from visfd_tpu_torch.cli import filter_mrc
    from visfd_tpu_torch.utils.progress import Report
    cell = manifest.cell(a.workload, ROOT)
    ref = cell.reference()
    config = cell.config
    w = config["parameters"]["voxel_width_A"]
    seeds = [int(s) for s in a.seeds.split(",") if s]
    controls = [int(s) for s in a.control_seeds.split(",") if s]
    shape = tuple(config["tomogram_zyx"])
    worst, least = {}, {}
    for seed in dict.fromkeys(seeds + controls):
        with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
            vol, mask = phantoms.make(cell.traffic, shape, w, seed,
                                      "cuda")
            inputs = {"input": os.path.join(tmp, "input.mrc")}
            mrcfile.write(inputs["input"], vol.cpu().numpy(), w)
            if mask is not None:
                inputs["mask"] = os.path.join(tmp, "mask.mrc")
                mrcfile.write(inputs["mask"], mask.cpu().numpy(), w)
            del vol, mask
            if seed in seeds:
                reqs = Requests(config, inputs, tmp)
                outputs = reqs.outputs(True)
                t0 = time.perf_counter()
                rc = filter_mrc.run(reqs.argv(outputs), device="cuda",
                                    report=Report(None))
                t1 = time.perf_counter()
                nums, info = ref.check(outputs, inputs, config, "cuda")
                print(json.dumps({"seed": seed, "side": "program", "rc": rc,
                                  "numbers": nums, "info": info,
                                  "program_s": t1 - t0,
                                  "check_s": time.perf_counter() - t1}),
                      flush=True)
                for k, v in nums.items():
                    worst[k] = max(worst.get(k, v), v)
            if seed in controls:
                t1 = time.perf_counter()
                nums = ref.control(inputs, config, "cuda")
                print(json.dumps({"seed": seed, "side": "control",
                                  "numbers": nums,
                                  "check_s": time.perf_counter() - t1}),
                      flush=True)
                for k, v in nums.items():
                    least[k] = min(least.get(k, v), v)
    print(json.dumps({"program_largest": worst, "control_smallest": least}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
