"""Open-loop traffic generator: replayable load scenarios for the serving
fleet (counterpart of paddle_tpu/serving/loadgen.py, a copy: the schedule
bytes are the reference's).

A ``Scenario`` declares everything about a traffic episode in plain JSON —
the arrival process (Poisson / diurnal / spike / batch), the prompt- and
output-length mixes (heavy-tailed lognormal, weighted choice, deterministic
cycle), and the tenant skew — and compiles it into a *schedule*: a list of
(arrival offset, tenant, prompt_len, max_new, phase) rows. The schedule is
a pure function of the scenario fields and its seed (``random.Random``
only, no wall clock, fixed draw order per event), so the same scenario
file replays byte-identically: ``schedule_doc()`` is canonical JSON and
two runs — or a save/load round-trip of the file — produce the same bytes.
That replayability is what makes autoscale drills pinnable evidence
rather than flaky load tests.

``LoadGenerator`` drives the schedule *open-loop* against a ReplicaRouter
(or a bare ServingEngine): requests are submitted at their scheduled
offsets regardless of completions — the defining property of an offered-
load harness; a closed loop would throttle itself exactly when the fleet
degrades, hiding the overload the drill exists to create. Between
arrivals it steps the router and invokes an optional ``on_tick`` hook
(SLO engine tick + CapacityController poll in the drills). Per-request
TTFT/TPOT/outcome flow through the engines' existing sinks (tenant
included); ``summary()`` reduces the episode to offered load vs goodput
and per-phase p50/p99.

Stdlib-only, no numpy — prompt token ids are plain int lists
(the engine normalizes).
"""
from __future__ import annotations

import json
import math
import random
import time
from typing import Callable, Dict, List, Optional, Sequence

ARRIVAL_PROCESSES = ("poisson", "diurnal", "spike", "batch")
LENGTH_DISTS = ("fixed", "lognormal", "choice", "cycle")

# hard cap on schedule length: a mis-typed rate must fail loudly, not OOM
MAX_EVENTS = 1_000_000


def _canon(doc) -> str:
    """Canonical JSON — the byte-identity the replay tests pin."""
    return json.dumps(doc, sort_keys=True, separators=(",", ":"))


def _draw_len(spec: dict, rnd: random.Random, index: int) -> int:
    """One length draw. Draw order is part of the replay contract: exactly
    one rnd consumption per call for the stochastic dists, zero for the
    deterministic ones."""
    dist = spec.get("dist", "fixed")
    if dist == "fixed":
        return int(spec["value"])
    if dist == "lognormal":
        # heavy-tailed: median/sigma parameterization (exp(mu) = median)
        v = rnd.lognormvariate(math.log(float(spec["median"])),
                               float(spec.get("sigma", 0.5)))
        lo = int(spec.get("min", 1))
        hi = int(spec.get("max", 1 << 30))
        return max(lo, min(hi, int(round(v))))
    if dist == "choice":
        values = spec["values"]
        weights = spec.get("weights")
        if weights is None:
            return int(values[int(rnd.random() * len(values))
                              % len(values)])
        return int(rnd.choices(values, weights=weights, k=1)[0])
    if dist == "cycle":
        # deterministic: request i takes values[i % n] (the reference
        # serve_bench's mixed-length ladder sweep); consumes no randomness
        values = spec["values"]
        return int(values[index % len(values)])
    raise ValueError(f"unknown length dist {dist!r} "
                     f"(expected one of {LENGTH_DISTS})")


def zipf_tenants(count: int, s: float = 1.1,
                 prefix: str = "t") -> List[dict]:
    """Zipf-skewed tenant table: weight(k) = 1/k^s — the canonical
    multi-tenant shape (a few tenants dominate the traffic)."""
    return [{"name": f"{prefix}{k}", "weight": 1.0 / (k + 1) ** float(s)}
            for k in range(count)]


class Scenario:
    """A replayable load scenario (see module doc for the JSON schema).

    Fields::

        name        str
        seed        int      — the only entropy source
        duration_s  float    — arrival horizon (scenario time)
        arrival     dict     — {"process": "poisson"|"diurnal"|"spike"|
                               "batch", "rate_rps": ..., ...}
        prompt_len  dict     — length dist (fixed|lognormal|choice|cycle)
        max_new     dict     — output-length dist (same grammar)
        tenants     [dict]   — [{"name", "weight"}]; skew = weights

    Arrival parameters: ``diurnal`` adds ``period_s`` + ``amplitude``
    (rate(t) = rate*(1 + A*sin(2πt/P)), phases "peak"/"trough");
    ``spike`` adds ``spike_at_s``, ``spike_len_s``, ``spike_factor``
    (phase "spike" inside the window, "base" outside); ``batch`` adds
    ``count`` (all arrivals at t=0 — the bench's submit-everything shape).
    """

    def __init__(self, name: str, seed: int = 0, duration_s: float = 10.0,
                 arrival: Optional[dict] = None,
                 prompt_len: Optional[dict] = None,
                 max_new: Optional[dict] = None,
                 tenants: Optional[Sequence[dict]] = None):
        self.name = str(name)
        self.seed = int(seed)
        self.duration_s = float(duration_s)
        self.arrival = dict(arrival or {"process": "poisson",
                                        "rate_rps": 1.0})
        proc = self.arrival.get("process")
        if proc not in ARRIVAL_PROCESSES:
            raise ValueError(f"unknown arrival process {proc!r} "
                             f"(expected one of {ARRIVAL_PROCESSES})")
        self.prompt_len = dict(prompt_len or {"dist": "fixed", "value": 8})
        self.max_new = dict(max_new or {"dist": "fixed", "value": 8})
        self.tenants = [dict(t) for t in
                        (tenants or [{"name": "default", "weight": 1.0}])]
        if not self.tenants:
            raise ValueError("Scenario needs at least one tenant")
        total = sum(float(t.get("weight", 1.0)) for t in self.tenants)
        if total <= 0:
            raise ValueError("tenant weights must sum > 0")
        self._cum = []
        acc = 0.0
        for t in self.tenants:
            acc += float(t.get("weight", 1.0)) / total
            self._cum.append((acc, t["name"]))

    # ------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        return {
            "name": self.name, "seed": self.seed,
            "duration_s": self.duration_s, "arrival": dict(self.arrival),
            "prompt_len": dict(self.prompt_len),
            "max_new": dict(self.max_new),
            "tenants": [dict(t) for t in self.tenants],
        }

    @classmethod
    def from_dict(cls, doc: dict) -> "Scenario":
        return cls(**doc)

    def dumps(self) -> str:
        return _canon(self.to_dict())

    @classmethod
    def loads(cls, text: str) -> "Scenario":
        return cls.from_dict(json.loads(text))

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(json.dumps(self.to_dict(), indent=2, sort_keys=True)
                    + "\n")
        return path

    @classmethod
    def load(cls, path: str) -> "Scenario":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    # ------------------------------------------------------------ arrivals
    def _rate_at(self, t: float) -> float:
        a = self.arrival
        base = float(a.get("rate_rps", 1.0))
        proc = a["process"]
        if proc == "poisson":
            return base
        if proc == "diurnal":
            period = float(a.get("period_s", self.duration_s))
            amp = float(a.get("amplitude", 0.5))
            return base * max(0.0, 1.0 + amp * math.sin(
                2.0 * math.pi * t / period))
        if proc == "spike":
            at = float(a.get("spike_at_s", self.duration_s / 3.0))
            ln = float(a.get("spike_len_s", self.duration_s / 3.0))
            if at <= t < at + ln:
                return base * float(a.get("spike_factor", 10.0))
            return base
        raise ValueError(proc)

    def _peak_rate(self) -> float:
        a = self.arrival
        base = float(a.get("rate_rps", 1.0))
        if a["process"] == "diurnal":
            return base * (1.0 + abs(float(a.get("amplitude", 0.5))))
        if a["process"] == "spike":
            return base * float(a.get("spike_factor", 10.0))
        return base

    def _phase_at(self, t: float) -> str:
        a = self.arrival
        proc = a["process"]
        if proc == "diurnal":
            return ("peak" if self._rate_at(t) >= float(a.get("rate_rps",
                                                              1.0))
                    else "trough")
        if proc == "spike":
            at = float(a.get("spike_at_s", self.duration_s / 3.0))
            ln = float(a.get("spike_len_s", self.duration_s / 3.0))
            return "spike" if at <= t < at + ln else "base"
        return "base"

    def _arrival_times(self, rnd: random.Random) -> List[float]:
        a = self.arrival
        if a["process"] == "batch":
            return [0.0] * int(a.get("count", 1))
        # thinning (Lewis & Shedler): draw a homogeneous Poisson stream at
        # the peak rate, keep each point with prob rate(t)/peak. Exactly
        # two rnd draws per candidate — the replay contract.
        peak = self._peak_rate()
        if peak <= 0:
            return []
        out = []
        t = 0.0
        for _ in range(MAX_EVENTS):
            t += rnd.expovariate(peak)
            if t >= self.duration_s:
                return out
            if rnd.random() * peak < self._rate_at(t):
                out.append(t)
        raise ValueError(
            f"scenario {self.name!r} exceeds {MAX_EVENTS} arrivals "
            f"(rate_rps x duration_s too large)")

    def _tenant(self, rnd: random.Random) -> str:
        r = rnd.random()
        for acc, name in self._cum:
            if r <= acc:
                return name
        return self._cum[-1][1]

    # ------------------------------------------------------------ schedule
    def schedule(self) -> List[dict]:
        """Compile the scenario into arrival rows, strictly deterministic
        in (fields, seed). Row: {"i", "t", "phase", "tenant",
        "prompt_len", "max_new"}."""
        rnd = random.Random(f"loadgen:{self.seed}:{self.name}")
        times = self._arrival_times(rnd)
        rows = []
        for i, t in enumerate(times):
            # fixed per-event draw order: tenant, prompt_len, max_new
            rows.append({
                "i": i, "t": round(t, 9), "phase": self._phase_at(t),
                "tenant": self._tenant(rnd),
                "prompt_len": _draw_len(self.prompt_len, rnd, i),
                "max_new": _draw_len(self.max_new, rnd, i),
            })
        return rows

    def schedule_doc(self) -> str:
        """The schedule as canonical JSON — byte-identical across runs and
        across a scenario-file save/load round-trip."""
        return _canon({"scenario": self.name, "seed": self.seed,
                       "schedule": self.schedule()})

    def prompt_tokens(self, index: int, prompt_len: int,
                      vocab: int) -> List[int]:
        """Deterministic per-request prompt ids: a function of (seed,
        index) only, so replays regenerate identical token streams without
        storing them in the scenario file."""
        rnd = random.Random(f"loadgen:{self.seed}:prompt:{index}")
        return [rnd.randrange(vocab) for _ in range(prompt_len)]


def _pctl(xs: Sequence[float], q: float) -> Optional[float]:
    if not xs:
        return None
    xs = sorted(xs)
    k = (len(xs) - 1) * q
    lo = int(k)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


class LoadGenerator:
    """Drive a Scenario's schedule open-loop against a router/engine.

    target: anything with ``submit(prompt_ids, max_new_tokens=...,
    tenant=...)`` + ``step()`` + ``pending()`` — a ReplicaRouter, or a
    bare ServingEngine (``pending()`` falls back to queue+active).
    prompt_fn(row) -> token ids overrides the default seeded prompts
    (vocab required for the default). time_scale compresses scenario
    seconds into wall seconds (0.1 = 10x faster); 0 submits as fast as
    the drive loop allows while preserving arrival *order*.
    """

    def __init__(self, scenario: Scenario, target,
                 prompt_fn: Optional[Callable[[dict], Sequence[int]]] = None,
                 vocab: Optional[int] = None, time_scale: float = 1.0,
                 submit_kwargs: Optional[dict] = None):
        if prompt_fn is None and vocab is None:
            raise ValueError("LoadGenerator needs prompt_fn or vocab")
        self.scenario = scenario
        self.target = target
        self.prompt_fn = prompt_fn
        self.vocab = vocab
        self.time_scale = float(time_scale)
        self.submit_kwargs = dict(submit_kwargs or {})
        self.handles: List = []      # (row, Request) pairs, arrival order
        self.schedule_ms: Optional[float] = None
        self._wall_t0: Optional[float] = None
        self._wall_t1: Optional[float] = None

    def _pending(self) -> int:
        t = self.target
        if hasattr(t, "pending"):
            return t.pending()
        return t.queue_depth() + int(t._active.sum())

    def _prompt(self, row: dict) -> Sequence[int]:
        if self.prompt_fn is not None:
            return self.prompt_fn(row)
        return self.scenario.prompt_tokens(row["i"], row["prompt_len"],
                                           self.vocab)

    def run(self, on_tick: Optional[Callable[[], None]] = None,
            drain: bool = True) -> List:
        """Submit every scheduled arrival at its (scaled) offset, stepping
        the target and calling ``on_tick`` between arrivals; with
        ``drain`` (default) keep driving until the fleet finishes every
        request. Returns the (row, Request) pairs."""
        t0 = time.perf_counter()
        rows = self.scenario.schedule()
        self.schedule_ms = (time.perf_counter() - t0) * 1000.0

        def tick():
            self.target.step()
            if on_tick is not None:
                on_tick()

        self._wall_t0 = time.perf_counter()
        for row in rows:
            due = self._wall_t0 + row["t"] * self.time_scale
            while time.perf_counter() < due:
                if self._pending():
                    tick()
                else:
                    if on_tick is not None:
                        on_tick()
                    time.sleep(min(0.001, max(0.0, due
                                              - time.perf_counter())))
            req = self.target.submit(
                self._prompt(row), max_new_tokens=row["max_new"],
                tenant=row["tenant"], **self.submit_kwargs)
            self.handles.append((row, req))
        while drain and self._pending():
            tick()
        self._wall_t1 = time.perf_counter()
        return self.handles

    # ------------------------------------------------------------- summary
    def summary(self) -> dict:
        """Scenario-summary doc: offered load vs goodput, outcome counts,
        per-phase and per-tenant breakdowns with p50/p99 TTFT/TPOT."""
        rows_reqs = self.handles
        wall_s = ((self._wall_t1 or time.perf_counter())
                  - (self._wall_t0 or time.perf_counter())) or 1e-9
        horizon = max([r["t"] for r, _ in rows_reqs] or [0.0]) or 1e-9
        outcomes: Dict[str, int] = {}
        per_phase: Dict[str, dict] = {}
        per_tenant: Dict[str, int] = {}
        good = 0
        for row, req in rows_reqs:
            o = req.outcome or ("ok" if req.done else "incomplete")
            outcomes[o] = outcomes.get(o, 0) + 1
            if o in ("ok", "eos", "length"):
                good += 1
            per_tenant[row["tenant"]] = per_tenant.get(row["tenant"], 0) + 1
            ph = per_phase.setdefault(row["phase"],
                                      {"n": 0, "ttft_ms": [], "tpot_ms": []})
            ph["n"] += 1
            if req.ttft_s is not None:
                ph["ttft_ms"].append(req.ttft_s * 1e3)
            if req.tpot_s is not None:
                ph["tpot_ms"].append(req.tpot_s * 1e3)
        phases = {}
        for name, ph in sorted(per_phase.items()):
            entry = {"n": ph["n"]}
            for key, xs in (("ttft_ms", ph["ttft_ms"]),
                            ("tpot_ms", ph["tpot_ms"])):
                for q in (50, 99):
                    v = _pctl(xs, q / 100)
                    entry[f"p{q}_{key}"] = (round(v, 3) if v is not None
                                            else None)
            phases[name] = entry
        return {
            "scenario": self.scenario.name, "seed": self.scenario.seed,
            "requests": len(rows_reqs),
            "offered_rps": round(len(rows_reqs) / horizon, 3),
            "goodput_rps": round(good / wall_s, 3),
            "good": good, "outcomes": outcomes,
            "wall_s": round(wall_s, 4),
            "time_scale": self.time_scale,
            "schedule_ms": (round(self.schedule_ms, 3)
                            if self.schedule_ms is not None else None),
            "per_phase": phases,
            "per_tenant": dict(sorted(per_tenant.items())),
        }


def spike_scenario(name: str = "spike10x", seed: int = 7,
                   duration_s: float = 6.0, rate_rps: float = 2.0,
                   spike_factor: float = 10.0,
                   prompt_median: int = 6, max_new: int = 3,
                   tenants: Optional[Sequence[dict]] = None) -> Scenario:
    """The pinned autoscale-drill shape: steady base load, a 10x spike in
    the middle third, heavy-tailed prompts, skewed tenants."""
    return Scenario(
        name=name, seed=seed, duration_s=duration_s,
        arrival={"process": "spike", "rate_rps": rate_rps,
                 "spike_at_s": duration_s / 3.0,
                 "spike_len_s": duration_s / 3.0,
                 "spike_factor": spike_factor},
        prompt_len={"dist": "lognormal", "median": prompt_median,
                    "sigma": 0.4, "min": 2, "max": 24},
        max_new={"dist": "fixed", "value": max_new},
        tenants=list(tenants) if tenants else zipf_tenants(3),
    )
