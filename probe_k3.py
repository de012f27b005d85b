#!/usr/bin/env python3
"""The particle window pass K3 on one GPU: its two paths and its floor.

    python3 probe_k3.py

At the inputs the port's dam_break(100000) step gives K3 after 30 steps
(port_fixtures.record_particle_calls), for each of its three phases:
- the kernel as built from box2d_tpu_torch/csrc/particles.cu, which stages
  each block's candidates in shared memory where they fit;
- the same source built with -DB2T_K3_NO_STAGE, which walks every block's
  candidates from global memory, and must agree with it bit for bit;
and once, the launch floor: a zero_() of one float. Each is timed by
port_fixtures.median_ms (device time, a call queued behind a device-side
wait). The first line is the card's name and power limit; the last, one
JSON object with every time. It needs a CUDA device.
"""

import ctypes
import json
import subprocess

import torch

from box2d_tpu_torch import particles_kernels as pk
from box2d_tpu_torch.cuda_build import nvcc_build
from port_fixtures import median_ms, record_particle_calls


def main():
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    pk.build()
    glob = nvcc_build(pk.SOURCE, "particles_no_stage",
                      defines=["B2T_K3_NO_STAGE"])[0]
    glob.b2t_particle_window.argtypes = pk.build().b2t_particle_window.argtypes
    k3, _, _ = record_particle_calls()
    one = torch.zeros(1, device="cuda")
    out = {"launch floor": median_ms(lambda: one.zero_())}
    print(f"[probe_k3] launch floor, zero_() of one float: "
          f"{out['launch floor']:.4f} ms")
    for args in k3:
        pos, skey, alive, p0, p1, scal, phase = args
        res = torch.empty((skey.shape[0], 2), device="cuda")
        paths = torch.zeros(2, dtype=torch.int32, device="cuda")

        def run_global(paths_ptr=None):
            rc = glob.b2t_particle_window(
                pos.data_ptr(), skey.data_ptr(), alive.data_ptr(),
                p0.data_ptr(), p1.data_ptr(), scal.data_ptr(),
                res.data_ptr(), paths_ptr, skey.shape[0], phase,
                torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"launch failed: cudaError {rc}")

        staged = torch.zeros(2, dtype=torch.int32, device="cuda")
        ref = pk.window_pass(*args, paths=staged)
        run_global(ctypes.c_void_p(paths.data_ptr()))
        torch.cuda.synchronize()
        assert torch.equal(res, ref), "the global path differs"
        assert paths.tolist() == [0, staged.sum().item()], paths
        t_kernel = median_ms(lambda: pk.window_pass(*args))
        t_global = median_ms(run_global)
        out[f"phase {phase}"] = dict(kernel=t_kernel, global_only=t_global,
                                     blocks_staged=staged.tolist()[0],
                                     blocks_global=staged.tolist()[1])
        print(f"[probe_k3] phase {phase}: kernel {t_kernel:.4f} ms "
              f"(blocks staged / global {staged.tolist()}), every block on "
              f"the global path {t_global:.4f} ms")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
