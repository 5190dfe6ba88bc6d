"""Run chip_smoke.py on the CPU at a small size, its kernels built by
``build.py`` (see ``plugin.py``), event timers on the host clock:

    python scripts/cuda_emu/build.py /tmp/emu
    EMU_BUILD=/tmp/emu PYTHONPATH=src:.:scripts/cuda_emu python scripts/cuda_emu/rehearse_smoke.py

Shrinks the sizes so that the whole script runs in about a minute; its
times mean nothing.  Arguments name phases (methods of ``Smoke``) to run
alone, in order.
"""
from __future__ import annotations

import subprocess
import sys
import time
import types

import torch

import plugin

plugin.install()

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402


class _Event:
    def __init__(self, enable_timing=True):
        self.t = None

    def record(self, *a):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


torch.cuda.Event = _Event
torch.cuda._sleep = lambda *a: None
torch.cuda.get_device_name = lambda *a: "emulated"
torch.cuda.device_count = lambda: 1
build.build = lambda names=None: {}


def _smi(cmd, **kw):
    """``nvidia-smi``: the card's name and limit, or its compute mode."""
    out = "Default\n" if any("compute_mode" in c for c in cmd) else "emulated, 0 W\n"
    return types.SimpleNamespace(stdout=out)


cs.subprocess = types.SimpleNamespace(run=_smi, Popen=subprocess.Popen, PIPE=subprocess.PIPE,
                                      TimeoutExpired=subprocess.TimeoutExpired)
# phase 10's gloo workers route the kernels to the same build (EMU_BUILD and
# PYTHONPATH are inherited)
cs.WORKER_PRELUDE = "import plugin\nplugin.install()\n"
# PACKED_REMOVALS 128 with 16 INCREMENTAL_EVENTS: fewer removals give a slot
# table too small for the single removals' deltas; 2 * SMALL_N <= 32767
# keeps its tables int16
for k, v in dict(N=12000, KEYS=2**12, DELTA_TABLE=24000, DELTA_UPDATES=256,
                 REPLICA_PROBE_KEYS=256, ASSIGN_HOST_KEYS=256, PACKED_REMOVALS=128,
                 INCREMENTAL_EVENTS=16, PACKED_RESTORES=8, SMALL_N=1000, ANCHOR_A=3200,
                 ANCHOR_W=800, BREAKDOWN_REPS=2, HOST_SAMPLE=256, KERNEL_SAMPLE=256,
                 FLUSH_BYTES=1 << 20, COLD_REPS=3, GATHER_WORDS=2**12,
                 GATHER_TABLE_MB=(1, 2), CLUSTER_HOSTS=200, CLUSTER_SHARDS=2**12,
                 CLUSTER_FAILS=6, CLUSTER_JOINS=3, CKPT_BYTES=1 << 20, PIPE_SHARDS=512,
                 PIPE_HOSTS=16, REPL_ANCHOR_BURST=50, REPL_PULL_REMOVALS=64,
                 REPL_FANOUT=3, GLOO_ROUNDS=4, REPL_ANCHOR_W=10**4).items():
    setattr(cs, k, v)
_init = cs.Smoke.__init__


def _cpu_init(self, torch):
    _init(self, torch)
    self.dev = torch.device("cpu")


cs.Smoke.__init__ = _cpu_init

if __name__ == "__main__":
    if len(sys.argv) > 1:
        smoke = cs.Smoke(torch)
        for phase in sys.argv[1:]:
            if phase == "phase_replay":  # its kernel rows are phase 2's
                smoke.phase_replay([])
            else:
                getattr(smoke, phase)()
    else:
        sys.exit(cs.main())
