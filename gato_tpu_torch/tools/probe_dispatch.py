"""The dispatch floor at the single-solve shape, on one CUDA card.

    python3 -m gato_tpu_torch.tools.probe_dispatch [--calls N] [--T T]

The counterpart of ``bench.py``'s ``bench_dispatch_floor``: the price of
ANY kernel call at IIWA (14, 7, 50), one problem, measured on row 18
(``kernels/probes.py``'s ``null_copy_cuda``: out = q * 1.0000001 on the
rhs, one float4 a thread), whose own work is nanoseconds.  Its wrapper
takes the port's short call path (``kernels/_build.py``'s ``checked`` and
``launch``: the device, type, shape and contiguity checks, the current
stream, the ctypes call, the error check, a device guard only off the
current device), the one row 15 takes, so its time a call is what a
kernel call of the port pays at least.  Three numbers, each beside the
one PyTorch call ``q * 1.0000001``:

* device: the kernel's own duration, the mean over ``calls`` launches in a
  ``torch.profiler`` trace (debug.trace);
* per call: host wall time of ``calls`` back-to-back calls, over calls,
  ending in ``torch.cuda.synchronize()``: the host's launch rate, since
  the device finishes each launch sooner;
* chain: ``timing.chain_time`` of dependent steps (a perturbation of q by
  the step counter and the previous output, then the call), T against 2T:
  what one step of a control loop costs on the device's clock.

Beside them, the split of row 18's call on host clocks, each step alone in
a loop as ``per call`` times it (``split_*_us``): the checks of one tensor
(``_build.checked``), the output's allocation (``torch.empty_like``), the
current-device query, the current stream's handle
(``torch.cuda.current_stream(i).cuda_stream``) and the ctypes call of the
launcher, which launches the kernel.

Prints one JSON line.  Needs a CUDA card (it raises without one).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np
import torch

from gato_tpu_torch import debug, testing, timing
from gato_tpu_torch.kernels import _build, probes
from gato_tpu_torch.solver import resolve_device


def cuda_device(device) -> torch.device:
    """``device`` as a torch.device; raises unless it is a CUDA card (the
    probes measure the card and have no CPU mode)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"the probes measure a CUDA card; got device {str(dev)!r}")
    return dev


def device_us(fn, calls: int, device) -> float:
    """Mean duration in us of the CUDA activity of one fn(), over ``calls``
    calls in one trace."""
    fn()
    torch.cuda.synchronize(device)
    with tempfile.TemporaryDirectory() as tmp:
        with debug.trace(tmp, device=device) as prof:
            for _ in range(calls):
                fn()
    busy = sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA)
    return busy / calls


def per_call_us(fn, calls: int, device) -> float:
    """Host wall time in us of one fn() among ``calls`` back-to-back calls."""
    fn()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize(device)
    return (time.perf_counter() - t0) / calls * 1e6


def chain_us(fn, q, T: int, reps: int, log=None, label: str = ""):
    """Per-step us of a chain of dependent steps ending in fn, and the
    chain_time info."""
    def step(q0, carry, t):
        pert = 1.0 + 1e-6 * torch.sin(t) + 1e-7 * torch.tanh(carry.sum())
        return fn(q0 * pert)

    ms, info = timing.chain_time(step, q, T, reps=reps, min_diff_ms=1.0,
                                 label=label, log=log)
    return ms * 1e3, info


def call_split_us(q, calls: int) -> dict:
    """Host us of each step of one ``null_copy_cuda(q)`` call, each alone
    in a loop of ``calls`` (per_call_us)."""
    device = q.device
    index = device.index
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(index).cuda_stream
    launcher = _build.function("gato_null_copy")
    args = (q.data_ptr(), out.data_ptr(), q.shape[0], q.shape[1] * q.shape[2], stream)
    steps = {
        "checked": lambda: _build.checked(probes.COPY_NAME, "q", q, tuple(q.shape), device),
        "empty_like": lambda: torch.empty_like(q),
        "current_device": torch.cuda.current_device,
        "current_stream": lambda: torch.cuda.current_stream(index).cuda_stream,
        "launcher": lambda: launcher(*args),
    }
    return {f"split_{name}_us": per_call_us(fn, calls, device) for name, fn in steps.items()}


def probe_dispatch(*, calls: int = 1000, T: int = 256, reps: int = 7,
                   device="cuda", log=None) -> dict:
    """The dispatch floor at IIWA, B = 1: row 18 and ``q * 1.0000001``."""
    dev = cuda_device(device)
    spec = testing.IIWA
    q = torch.tensor(np.asarray(testing.random_blocks(spec, seed=7).q)[None],
                     dtype=torch.float32, device=dev)
    out = {"probe": "dispatch_floor", "K": spec.knot_points, "s": spec.state_size,
           "batch": 1, "calls": calls}
    # The torch call is row 18's plain version, q * 1.0000001.
    for name, one in (("kernel", probes.null_copy_cuda),
                      ("torch", probes.null_copy_plain)):
        fn = lambda one=one: one(q)  # noqa: E731
        out[f"{name}_device_us"] = device_us(fn, calls, dev)
        out[f"{name}_per_call_us"] = per_call_us(fn, calls, dev)
        us, info = chain_us(one, q, T, reps, log=log, label=f"dispatch/{name}")
        out[f"{name}_chain_us"] = us
        out[f"{name}_chain_T"] = info["T"]
        if "noise_warning" in info:
            out[f"{name}_chain_noise_warning"] = info["noise_warning"]
    out.update(call_split_us(q, calls))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--calls", type=int, default=1000)
    ap.add_argument("--T", type=int, default=256)
    args = ap.parse_args(argv)
    out = probe_dispatch(calls=args.calls, T=args.T,
                         log=lambda m: print(m, file=sys.stderr, flush=True))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
