"""The card's clock, power and temperature, sampled by ``nvidia-smi`` once
a second beside the measured window (the 989 TFLOP/s peak assumes the SM
clock at 1.83 GHz and the 700 W limit)."""
from __future__ import annotations

import shutil
import statistics
import subprocess
from typing import Optional

FIELDS = ("clocks.sm", "power.draw", "power.limit", "temperature.gpu")


class Sampler:
    def __init__(self, index: int = 0):
        self.proc: Optional[subprocess.Popen] = None
        exe = shutil.which("nvidia-smi")
        if exe:
            self.proc = subprocess.Popen(
                [exe, f"--query-gpu={','.join(FIELDS)}", "--format=csv,noheader,nounits",
                 "-lms", "1000", "-i", str(index)],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def stop(self) -> dict:
        """Ends the sampler, waits for it, and returns each field's median,
        min and max over the samples."""
        if self.proc is None:
            return {"samples": 0}
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        rows = []
        for line in out.splitlines():
            try:
                rows.append([float(v) for v in line.split(",")])
            except ValueError:
                continue
        res = {"samples": len(rows)}
        for i, f in enumerate(FIELDS):
            vals = [r[i] for r in rows if len(r) == len(FIELDS)]
            if vals:
                res[f] = {"median": statistics.median(vals), "min": min(vals), "max": max(vals)}
        return res
