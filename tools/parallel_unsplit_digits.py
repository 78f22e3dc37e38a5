"""The port's results on the unsplit models of tests/test_torch_parallel.py
(the 64x16 MG plate on two threads, the 16x4 dense plate, the 8x36 band
wing and PlateSim 16x4 on the step MG on one), as the test's ranks run
them:

    python tools/parallel_unsplit_digits.py [--root CHECKOUT]

`--root` names the checkout whose femo_alpha_tpu_torch runs (default: this
one); the jobs are this checkout's tests/torch_parallel_cases.py. Run from
a checkout of the commit before femo_alpha_tpu_torch/parallel/ existed, it
pins what the unsplit path gave then, which the test holds every later
commit to, bit for bit. Writes tests/reference_digits/parallel_unsplit.npz
(~40 s).
"""

import argparse
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    torch.set_num_threads(1)
    import femo_alpha_tpu_torch
    import torch_parallel_cases as cases

    print("femo_alpha_tpu_torch from", femo_alpha_tpu_torch.__file__)
    out = {}
    for case in ("plate64", "plate16", "wing"):
        # the test's one-rank 64x16 plate runs on 2 threads (its longest job)
        r = cases.model_case(None, case, split=False,
                             threads=2 if case == "plate64" else 1)
        out.update({f"{case}_J": r["J"], f"{case}_u": r["u"],
                    f"{case}_g": r["g"]})
        print(case, repr(r["J"]), r["route"], flush=True)
    r = cases.sim_case(None, split=False)
    out.update(sim_J=r["J"], sim_w=r["w"], sim_g=r["g"])
    print("sim", repr(r["J"]), flush=True)
    path = os.path.join(ROOT, "tests", "reference_digits",
                        "parallel_unsplit.npz")
    np.savez(path, **out)
    print("wrote", path)


if __name__ == "__main__":
    main()
