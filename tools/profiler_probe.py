#!/usr/bin/env python3
"""Why does ``torch.profiler`` lose the event of a one-kernel session late
in a long process?

    python3 tools/profiler_probe.py [SECONDS]

Profiles sessions of one small kernel (an add of two 1 Mi-float tensors).
First three, each a JSON line with the device events seen and the card's
free memory (``cudaMemGetInfo``): after a session of 20,000 adds (about as
many kernels as the polish profile of ``chip_smoke.py``); with PyTorch's
caching allocator holding all but ~256 MiB of the card (a tensor allocated
and freed, as a large plain-version run leaves it); after
``torch.cuda.empty_cache()``. Then, for SECONDS (default 180) of adds on
the card, every ~10 s one session as it comes and one with 50 ms of host
time before and after the add: a JSON line each with the process's age,
the events of both and, in the padded one, the kernel's start minus the
start of the host op that launched it on the profiler's clock (a few us
when the device and host clocks agree). Last, the card's name and power
limit.
"""

import json
import subprocess
import sys
import time


def session(a, b, n=1, pad_s=0.0):
    """(device events, kernel start - launching op start in us) of ``n``
    profiled adds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_s)
        for _ in range(n):
            torch.add(a, b)
        torch.cuda.synchronize()
        time.sleep(pad_s)
    dev = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
    ops = [e for e in prof.events() if e.name == "aten::add"]
    skew = (dev[0].time_range.start - ops[0].time_range.start
            if dev and ops else None)
    return len(dev), skew


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profiler_probe: CUDA is not available", file=sys.stderr)
        return 1
    seconds = float(sys.argv[1]) if len(sys.argv) > 1 else 180.0
    t0 = time.perf_counter()
    a = torch.ones(1 << 20, device="cuda")
    b = torch.ones_like(a)
    for state in ("after 20000 adds", "cache full", "cache emptied"):
        if state == "after 20000 adds":
            session(a, b, 20000)
        elif state == "cache full":
            free, _ = torch.cuda.mem_get_info()
            del_me = torch.empty(free - (256 << 20), dtype=torch.uint8,
                                 device="cuda")
            del del_me
        else:
            torch.cuda.empty_cache()
        free, _ = torch.cuda.mem_get_info()
        print(json.dumps({"state": state, "device_events": session(a, b)[0],
                          "free_bytes": free}), flush=True)
    while time.perf_counter() - t0 < seconds:
        t1 = time.perf_counter()
        while time.perf_counter() - t1 < 10:
            for _ in range(1000):
                torch.add(a, b)
            torch.cuda.synchronize()
        bare, _ = session(a, b)
        padded, skew = session(a, b, pad_s=0.05)
        print(json.dumps({"age_s": round(time.perf_counter() - t0, 1),
                          "events": bare, "events_padded": padded,
                          "kernel_minus_op_us": skew}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
