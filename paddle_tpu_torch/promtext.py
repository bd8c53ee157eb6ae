"""Strict Prometheus text-exposition parsing and validation.

The port's copy of ``paddle_tpu/promtext.py``, line for line (importing
the JAX package's module would import jax): the fleet router's
federation scraper (:mod:`paddle_tpu_torch.serving.router` pulls each
replica's ``/metrics`` and needs the samples back as numbers, not
lines) and the tests read the exposition through it.  It stays
stdlib-only.

Two layers:

* :func:`validate_lines` — strict validation, returning
  ``(lineno, message)`` pairs.  Enforced: every non-comment line is a
  well-formed sample (``name{labels} value [timestamp]``); metric
  names match the Prometheus charset; every sample's family carries
  ``# HELP``/``# TYPE`` lines preceding its samples; at most one
  HELP/TYPE per family; TYPE values are real Prometheus types; no
  duplicate series (same name + label set); histogram families expose
  ``_bucket``/``_sum``/``_count`` with a ``+Inf`` bucket.
* :func:`parse_exposition` — the scraper's view: the same strict walk
  producing a ``{family: Family}`` map of typed samples with parsed
  label dicts (histogram components fold under their family), so the
  router can sum counters and merge bucket vectors without re-implying
  any format knowledge.
"""
from __future__ import annotations

import math
import re
from typing import Dict, List, Optional, Tuple

__all__ = ["PROM_NAME_RE", "PROM_TYPES", "Sample", "Family",
           "validate_lines", "parse_exposition", "parse_labels",
           "merged_histogram_percentile"]

PROM_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
PROM_TYPES = {"counter", "gauge", "histogram", "summary", "untyped"}
SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"           # metric name
    r"(\{[^{}]*\})?"                          # optional {labels}
    r" (-?(?:[0-9.eE+-]+|\+?Inf|-Inf|NaN))"   # value (one space before)
    r"( [0-9]+)?$")                           # optional ms timestamp
LABELS_RE = re.compile(
    r'^\{(?:[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*"'
    r'(?:,[a-zA-Z_][a-zA-Z0-9_]*="(?:[^"\\]|\\.)*")*,?)?\}$')
_LABEL_PAIR_RE = re.compile(
    r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


class Sample:
    """One parsed sample line: ``name{labels} value``."""

    __slots__ = ("name", "labels", "value", "lineno")

    def __init__(self, name: str, labels: Dict[str, str], value: float,
                 lineno: int):
        self.name = name
        self.labels = labels
        self.value = value
        self.lineno = lineno

    def __repr__(self):
        return f"Sample({self.name!r}, {self.labels!r}, {self.value})"


class Family:
    """One metric family: its TYPE, HELP, and samples.  Histogram
    component samples (``x_bucket``/``x_sum``/``x_count``) fold under
    family ``x``."""

    __slots__ = ("name", "type", "help", "samples")

    def __init__(self, name: str, type_: str = "untyped",
                 help_: str = ""):
        self.name = name
        self.type = type_
        self.help = help_
        self.samples: List[Sample] = []

    # -- convenience accessors for the federation scraper -------------------
    def value(self) -> Optional[float]:
        """The bare (unlabeled, non-component) sample's value — what a
        counter/gauge family exposes.  Labeled samples never qualify:
        a family carrying only per-label series (e.g. a federated
        ``fleet_*`` family scraped from another router, whose labeled
        samples precede the unlabeled aggregate) must not have one
        arbitrary label's value misread as the process total."""
        for s in self.samples:
            if s.name == self.name and not s.labels:
                return s.value
        return None

    def histogram_buckets(self) -> List[Tuple[float, float]]:
        """``(le_upper_bound, cumulative_count)`` pairs, +Inf last."""
        out = []
        for s in self.samples:
            if s.name == self.name + "_bucket" and "le" in s.labels:
                le = s.labels["le"]
                ub = math.inf if le in ("+Inf", "Inf") else float(le)
                out.append((ub, s.value))
        out.sort(key=lambda t: t[0])
        return out

    def histogram_sum(self) -> float:
        for s in self.samples:
            if s.name == self.name + "_sum":
                return s.value
        return 0.0

    def histogram_count(self) -> float:
        for s in self.samples:
            if s.name == self.name + "_count":
                return s.value
        return 0.0


_ESCAPES = {"n": "\n", '"': '"', "\\": "\\"}


def _unescape_label(v: str) -> str:
    """Left-to-right escape decoding (``\\n``, ``\\"``, ``\\\\``).
    Chained str.replace would corrupt values where one replacement
    manufactures another's pattern (``C:\\\\net`` must decode to a
    backslash + ``net``, not a newline)."""
    if "\\" not in v:
        return v
    out = []
    i = 0
    while i < len(v):
        c = v[i]
        if c == "\\" and i + 1 < len(v):
            nxt = v[i + 1]
            out.append(_ESCAPES.get(nxt, "\\" + nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def parse_labels(text: str) -> Dict[str, str]:
    """``{a="b",c="d"}`` -> dict (values keep their escapes resolved)."""
    out: Dict[str, str] = {}
    for k, v in _LABEL_PAIR_RE.findall(text or ""):
        out[k] = _unescape_label(v)
    return out


def _family_of(name: str, typed: dict) -> str:
    """Map a histogram/summary component sample back to its family
    (``x_bucket``/``x_sum``/``x_count`` -> ``x`` when ``x`` is typed
    histogram or summary)."""
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix):
            base = name[: -len(suffix)]
            if typed.get(base) in ("histogram", "summary"):
                return base
    return name


def _walk(text: str, families: Optional[Dict[str, Family]]
          ) -> List[Tuple[int, str]]:
    """The shared strict walk: fills ``families`` (when given) and
    returns ``(lineno, message)`` validation findings."""
    errors: List[Tuple[int, str]] = []
    helped: dict = {}
    typed: dict = {}
    type_line: dict = {}
    sampled_families = set()
    seen_series: dict = {}
    bucket_infs: dict = {}

    def fam_get(name: str) -> Family:
        f = families.get(name)
        if f is None:
            f = families[name] = Family(name)
        return f

    for lineno, line in enumerate(text.splitlines(), 1):
        def err(msg):
            errors.append((lineno, f"{msg} -- {line[:80]!r}"))

        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            kind = parts[1] if len(parts) > 1 else ""
            if kind not in ("HELP", "TYPE"):
                continue  # free-form comment: allowed
            if len(parts) < 3:
                err(f"{kind} line without a metric name")
                continue
            name = parts[2]
            if not PROM_NAME_RE.match(name):
                err(f"bad metric name {name!r} in {kind} line")
                continue
            book = helped if kind == "HELP" else typed
            if name in book:
                err(f"duplicate # {kind} for {name}")
            if kind == "HELP":
                if len(parts) < 4 or not parts[3].strip():
                    err(f"HELP for {name} has empty docstring")
                helped.setdefault(name, lineno)
                if families is not None:
                    fam_get(name).help = parts[3].strip() \
                        if len(parts) > 3 else ""
            else:
                t = parts[3].strip() if len(parts) > 3 else ""
                if t not in PROM_TYPES:
                    err(f"TYPE for {name} is {t!r}, not one of "
                        f"{sorted(PROM_TYPES)}")
                typed.setdefault(name, t)
                type_line.setdefault(name, lineno)
                if name in sampled_families:
                    err(f"# TYPE for {name} appears after its samples")
                if families is not None and t in PROM_TYPES:
                    fam_get(name).type = t
            continue
        m = SAMPLE_RE.match(line)
        if not m:
            err("malformed sample line (want 'name{labels} value "
                "[timestamp]', single spaces)")
            continue
        name, labels, value = m.group(1), m.group(2) or "", m.group(3)
        if labels and not LABELS_RE.match(labels):
            err(f"malformed label set {labels!r}")
        try:
            fval = float(value.replace("Inf", "inf")
                         .replace("NaN", "nan"))
        except ValueError:
            err(f"unparseable sample value {value!r}")
            fval = math.nan
        series = (name, labels)
        if series in seen_series:
            err(f"duplicate series {name}{labels} (first at line "
                f"{seen_series[series]})")
        else:
            seen_series[series] = lineno
        fam = _family_of(name, typed)
        sampled_families.add(fam)
        if fam not in typed:
            err(f"sample for {name} with no preceding # TYPE {fam}")
        elif fam not in helped:
            err(f"sample for {name} with no # HELP {fam}")
        if families is not None:
            fam_get(fam).samples.append(
                Sample(name, parse_labels(labels), fval, lineno))
        if typed.get(fam) == "histogram" and name == fam + "_bucket":
            if 'le="+Inf"' in labels:
                bucket_infs[fam] = True
            bucket_infs.setdefault(fam, False)

    for fam, has_inf in sorted(bucket_infs.items()):
        if not has_inf:
            errors.append((type_line.get(fam, 0),
                           f"histogram {fam} has no le=\"+Inf\" bucket"))
    for fam in sorted(f for f, t in typed.items() if t == "histogram"):
        if fam in sampled_families:
            for part in ("_sum", "_count"):
                if (fam + part, "") not in seen_series:
                    errors.append((type_line.get(fam, 0),
                                   f"histogram {fam} is missing "
                                   f"{fam}{part}"))
    return errors


def validate_lines(text: str) -> List[Tuple[int, str]]:
    """Strict validation only: ``(lineno, message)`` findings, empty =
    valid exposition."""
    return _walk(text, None)


def parse_exposition(text: str, strict: bool = False
                     ) -> Dict[str, Family]:
    """Parse an exposition document into ``{family_name: Family}``.

    ``strict=True`` raises ``ValueError`` on the first validation
    finding; the default keeps scraping best-effort (a fleet view must
    not go blind because one replica shipped a malformed family — the
    well-formed families still parse)."""
    families: Dict[str, Family] = {}
    errors = _walk(text, families)
    if strict and errors:
        ln, msg = errors[0]
        raise ValueError(f"line {ln}: {msg} (+{len(errors) - 1} more)")
    return families


def merged_histogram_percentile(buckets: List[Tuple[float, float]],
                                p: float) -> Optional[float]:
    """Percentile (``p`` in [0, 100]) over a merged cumulative-bucket
    vector — the fleet-aggregate latency math: element-wise-summed
    ``(le, cumulative_count)`` pairs from N replicas interpolate
    exactly like one histogram's.  An estimate landing in the +Inf
    bucket is censored to the top finite edge (the same no-extrapolate
    contract as :class:`paddle_tpu_torch.telemetry.Histogram`).  None on an
    empty histogram."""
    if not buckets:
        return None
    buckets = sorted(buckets, key=lambda t: t[0])
    total = buckets[-1][1]
    if total <= 0:
        return None
    rank = p / 100.0 * total
    prev_ub, prev_cum = 0.0, 0.0
    top_finite = max((ub for ub, _ in buckets if math.isfinite(ub)),
                     default=0.0)
    for ub, cum in buckets:
        if cum >= rank and cum > prev_cum:
            if math.isinf(ub):
                return top_finite  # censored: only a floor is known
            frac = (rank - prev_cum) / (cum - prev_cum)
            return prev_ub + (ub - prev_ub) * min(max(frac, 0.0), 1.0)
        prev_ub, prev_cum = (0.0 if math.isinf(ub) else ub), cum
    return top_finite
