"""The card's clocks through a window: one `nvidia-smi` process beside it,
sampling every 200 ms the SM clock and its maximum, the memory clock, the
power draw, the temperature and the active clock-event (throttle) reasons,
and one reading of the compute processes on the card at the start and at
the end.

    sampler = Sampler().start()
    ...                      # the window
    got = sampler.stop()     # {"samples": [...], "notes": [...]}

A sample is a dict: `sm_mhz`, `max_sm_mhz`, `mem_mhz`, `power_w`,
`temp_c` (floats, None where the card does not say) and `reasons` (the
reasons' bit mask, an int). A driver that knows no `clocks_event_reasons`
is asked for `clocks_throttle_reasons`. Without `nvidia-smi` there are no
samples, and a note says why: nothing stands in for a reading."""

from __future__ import annotations

import os
import shutil
import statistics
import subprocess
import threading

PERIOD_MS = 200
FIELDS = "timestamp,clocks.sm,clocks.max.sm,clocks.mem,power.draw,temperature.gpu,{reasons}"
REASON_FIELDS = ("clocks_event_reasons.active", "clocks_throttle_reasons.active")
# NVML's clock-event reason bits
REASONS = {0x1: "gpu_idle", 0x2: "applications_clocks_setting", 0x4: "sw_power_cap",
           0x8: "hw_slowdown", 0x10: "sync_boost", 0x20: "sw_thermal_slowdown",
           0x40: "hw_thermal_slowdown", 0x80: "hw_power_brake_slowdown",
           0x100: "display_clock_setting"}
# a sample whose SM clock is below this share of its maximum reads as low
LOW = 0.97


def _run(args: list) -> subprocess.CompletedProcess | None:
    try:
        return subprocess.run(["nvidia-smi", *args], capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None


def _number(text: str):
    try:
        return float(text)
    except ValueError:
        return None


def parse(line: str) -> dict | None:
    """One sample from a line of the query (csv, no header, no units), or
    None for a line that is not one."""
    parts = [p.strip() for p in line.split(",")]
    if len(parts) != 7:
        return None
    try:
        reasons = int(parts[6], 16)
    except ValueError:
        return None
    sm, max_sm, mem, power, temp = (_number(p) for p in parts[1:6])
    if sm is None or max_sm is None:
        return None
    return {"sm_mhz": sm, "max_sm_mhz": max_sm, "mem_mhz": mem, "power_w": power,
            "temp_c": temp, "reasons": reasons}


def low_share(samples: list) -> float | None:
    """The share (%) of the samples whose SM clock is below LOW of its
    maximum, or None without samples."""
    if not samples:
        return None
    low = sum(1 for s in samples if s["sm_mhz"] < LOW * s["max_sm_mhz"])
    return 100.0 * low / len(samples)


def reason_names(mask: int) -> str:
    names = [n for bit, n in REASONS.items() if mask & bit]
    return "+".join(names) if names else "none"


def compute_apps() -> list | None:
    """(pid, used MiB) of every compute process on the cards, or None when
    nvidia-smi cannot say."""
    out = _run(["--query-compute-apps=pid,used_memory", "--format=csv,noheader,nounits"])
    if out is None or out.returncode != 0:
        return None
    apps = []
    for line in out.stdout.strip().splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit():
            apps.append((int(parts[0]), parts[1]))
    return apps


class Sampler:
    def __init__(self, period_ms: int = PERIOD_MS, card: int = 0):
        self.period_ms, self.card = period_ms, card
        self.why = None
        self.lines: list = []
        self.apps_start = None
        self._proc = None
        self._reader = None

    def _reason_field(self) -> str | None:
        for field in REASON_FIELDS:
            out = _run([f"--query-gpu={field}", "--format=csv,noheader", f"--id={self.card}"])
            if out is not None and out.returncode == 0:
                return field
        return None

    def start(self) -> "Sampler":
        if shutil.which("nvidia-smi") is None:
            self.why = "no nvidia-smi on this machine"
            return self
        field = self._reason_field()
        if field is None:
            self.why = "nvidia-smi answers neither " + " nor ".join(REASON_FIELDS)
            return self
        self.apps_start = compute_apps()
        self._proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={FIELDS.format(reasons=field)}",
             "--format=csv,noheader,nounits", f"--id={self.card}",
             f"--loop-ms={self.period_ms}"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()
        return self

    def _read(self) -> None:
        for line in self._proc.stdout:
            self.lines.append(line)

    def stop(self) -> dict:
        """The samples and the notes that say what they show."""
        if self._proc is None:
            return {"samples": [], "notes": [f"card clocks: not sampled ({self.why})"]}
        self._proc.terminate()
        try:
            self._proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self._proc.kill()
            self._proc.wait(timeout=10)
        self._reader.join(timeout=10)
        apps_end = compute_apps()
        samples = [s for s in map(parse, self.lines) if s is not None]
        return {"samples": samples, "notes": self._notes(samples, apps_end)}

    def _notes(self, samples: list, apps_end) -> list:
        if not samples:
            return [f"card clocks: nvidia-smi gave no sample in {len(self.lines)} lines"]
        sm = [s["sm_mhz"] for s in samples]
        reasons: dict = {}
        for s in samples:
            reasons[s["reasons"]] = reasons.get(s["reasons"], 0) + 1
        notes = [f"card clocks over the window: {len(samples)} samples every {self.period_ms} ms; "
                 f"SM MHz min {min(sm):g}, median {statistics.median(sm):g}, max {max(sm):g} "
                 f"(max clock {samples[0]['max_sm_mhz']:g}); below {LOW:g} of the max: "
                 f"{low_share(samples):.1f}%; power W max "
                 f"{max((s['power_w'] or 0.0) for s in samples):g}; temperature C max "
                 f"{max((s['temp_c'] or 0.0) for s in samples):g}",
                 "card clock-event reasons seen (samples): " + ", ".join(
                     f"{m:#x} {reason_names(m)} ({n})" for m, n in sorted(reasons.items()))]
        me = os.getpid()
        for when, apps in (("start", self.apps_start), ("end", apps_end)):
            if apps is None:
                notes.append(f"card compute processes at the window's {when}: not readable")
                continue
            others = [a for a in apps if a[0] != me]
            notes.append(f"card compute processes at the window's {when}: {len(apps)}, other "
                         f"than this run's: {others or 'none'}")
        return notes
