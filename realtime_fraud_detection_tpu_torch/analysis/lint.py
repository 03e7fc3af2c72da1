"""``lint``: AST-level checker for the port's own invariants.

Generic linters cannot see that ``time.monotonic()`` inside ``qos/`` breaks
``qos-drill``'s bit-identical virtual-clock replay, or that one ``.cpu()`` on
a CUDA tensor inside the scorer's dispatch half stalls the host until the
stream drains and so ends the overlap of the batches in flight. These rules
encode exactly those contracts, the JAX package's rules keyed to this tree:

``wall-clock``
    No bare ``time.time()/monotonic()/perf_counter()`` (or
    ``datetime.now()``) in the virtual-clock-capable subsystems
    (CLOCK_SUBSYSTEMS). Wall clock must arrive through an injected
    ``clock``/``now`` seam; the genuinely wall-clock sites carry
    ``# rtfd-lint: allow[wall-clock] <why>``.

``d2h``
    No blocking device->host pull in the dispatch-path scopes
    (D2H_MODULES / D2H_FUNCTIONS): ``np.asarray`` / ``np.array`` /
    ``np.ascontiguousarray``, ``.item()``, ``float(<non-literal>)``, and
    torch's blocking pulls ``.cpu()``, ``.numpy()``, ``.tolist()``,
    ``.synchronize()`` and ``torch.cuda.synchronize()``. Recording a
    ``torch.cuda.Event`` and a ``copy_``/``to`` with ``non_blocking=True``
    queue on the stream and are the safe forms. Host-array conversions that
    can never see a device tensor are annotated, which doubles as
    documentation of WHY they are safe.

``metrics``
    Prometheus hygiene for the shared exposition: counters end in
    ``_total`` and are snake_case (gauges/histograms must NOT claim
    ``_total``), every MetricsCollector counter has exactly one writing
    plane outside obs/metrics.py (or lives behind a ``sync_*``/``record_*``
    mirror inside it), no counter ever ``.inc(<variable>)``s a raw
    cumulative total from outside the collector (that is what the
    counter-delta ``sync_*`` mirrors are for), and no dead series.

``lock-order``
    Param / degradation-mask mutation (MUTATORS) must be reached under the
    score lock — a call-graph walk: a mutation site is fine if it is
    lexically under a ``with <...lock...>``, receives ``lock=``, or if
    every package caller chain that reaches it holds one; the single-
    threaded entry points (drills, the stream job's run loop) are
    annotated where they are single-writer by construction. Also: no
    blocking queue op / ``time.sleep`` / thread join while lexically
    inside a ``with``-lock body. The call sites and enclosing functions
    are indexed once per run, so the walk costs seconds on the whole tree.

``determinism``
    No global-RNG ``random.*`` / ``np.random.*`` draws, and no torch draw
    from the global generator (``torch.rand``/``randn``/``randint``/
    ``randperm``/``normal``/``bernoulli``/``multinomial`` and the in-place
    ``uniform_``/``normal_``/``random_``/``bernoulli_``/``exponential_``
    without ``generator=``, ``torch.manual_seed``, ``torch.seed``) in
    ``sim/``, any ``*drill*`` module, the quantization calibrators
    (``DETERMINISM_MODULES``), or the subsystems of DETERMINISM_SUBSYSTEMS
    — seeded generator instances (``np.random.default_rng(seed)``,
    ``random.Random(seed)``, a seeded ``torch.Generator`` passed as
    ``generator=``) only, so every drill replays bit-identically and the
    same weights always calibrate to the same int8 blobs.

``pragma-hygiene``
    Every ``# rtfd-lint: allow[rule]`` must name a known rule and still
    suppress a real finding — a pragma that stops matching (the code
    under it was fixed or moved) is itself an error, so stale waivers
    cannot accumulate.

Pragmas apply to their own line, or — as a comment-only line — to the
next code line. ``allow[a,b]`` names several rules at once. The module
imports only the standard library: ``python -m
realtime_fraud_detection_tpu_torch lint`` runs without torch.
"""

from __future__ import annotations

import ast
import io
import json
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Set, Tuple

__all__ = [
    "Finding",
    "RULES",
    "format_findings",
    "lint_paths",
    "lint_source",
    "run_lint",
]

PACKAGE_NAME = "realtime_fraud_detection_tpu_torch"

# Subsystems that can run under the drills' virtual clock: a bare wall-
# clock read here silently diverges a replay. (chaos/: the ChaosPlan and
# link-fault layer never reads time by contract — clocks and sleep seams
# are injected; partition_drill.py's real-process pacing carries justified
# pragmas like elastic_drill.)
CLOCK_SUBSYSTEMS = frozenset(
    {"qos", "tuning", "feedback", "obs", "stream", "serving", "scoring",
     "sim", "cluster", "chaos", "graph"})

# Whole modules under the dispatch-path d2h contract: a blocking pull here
# stalls the host until the stream drains, so the next batch's launches
# queue behind it and the batches in flight stop overlapping.
D2H_MODULES = frozenset({
    "scoring/device_pool.py",
    "scoring/host_pipeline.py",
    "scoring/pool_drill.py",
    # quantized scoring plane: calibration is host-side work at model-swap
    # time by contract — every np.asarray there must be a justified pragma,
    # and anything unexplained is a dispatch-path leak. (scoring/
    # quant_drill.py is deliberately NOT here: like the other drills it is
    # an oracle-comparison harness whose whole job is pulling both
    # programs' scores host-side; determinism scope still applies via the
    # *drill* name convention.)
    "models/quant.py",
    # mesh-sharded serving plane: the executor's dispatch path is under the
    # same contract as the pool's — wait() is the designated pull
    # (scoring/mesh_drill.py rides the *drill* determinism convention and
    # is an oracle harness like pool_drill, which is already here).
    "scoring/mesh_executor.py",
    "scoring/mesh_drill.py",
    # kernel plane: the wrappers sit directly inside the dispatch — any
    # host pull there would stall every launch, so all the wrapper modules
    # carry the full-module d2h contract. (scoring/kernel_drill.py rides
    # the *drill* determinism convention and is an oracle harness like
    # quant_drill, deliberately NOT here.)
    "ops/attention.py",
    "ops/dequant_matmul.py",
    "ops/epilogue.py",
    # persistent megakernel: the whole-batch program IS the dispatch — a
    # host pull anywhere in it would serialize every launch
    "ops/megakernel.py",
})
# Function-scoped d2h contract: the scorer's dispatch half must stay
# pull-free (finalize is the designated pull point).
D2H_FUNCTIONS: Dict[str, frozenset] = {
    "scoring/scorer.py": frozenset({"dispatch", "dispatch_assembled"}),
    # the text analyzer's encoder call on the card: one designated pull
    "models/text.py": frozenset({"score_texts"}),
}

# Modules under the determinism contract beyond the sim/ + *drill*
# name conventions: int8 calibration must be a pure function of the
# weights (hot-swap on N replicas and checkpoint round-trips both assume
# the same f32 weights always quantize to the same blobs).
DETERMINISM_MODULES = frozenset({
    "models/quant.py",
    # link-fault layer: fault schedules ride worker specs across the
    # process boundary and must replay bit-identically inside a fresh
    # interpreter — seeded rng instances only, no global RNG
    "chaos/netfaults.py",
    # fleet observability plane: the coordinator's metric fold and trace
    # stitching feed obs-drill's digest — the aggregation must be a pure
    # function of the ingested events/rings
    "obs/fleetmetrics.py",
})
# Whole subsystems under the determinism contract: every cluster/ module
# is replay-critical — ring placement, partition routing, handoff
# snapshots, and the shard drill must all be pure functions of their
# seeds/inputs, or shard-drill's bit-identical second run lies.
DETERMINISM_SUBSYSTEMS = frozenset({
    "cluster",
    # entity-graph plane: the typed store rides PartitionState handoff
    # blobs and the sampler/fetch results feed score content — graph-
    # drill's digest-identical fresh second run requires every module to
    # be a pure function of its inputs (seeded rng only)
    "graph",
    # kernel plane: kernels must be pure functions of their operands or
    # kernel-drill's parity digest lies — no hidden RNG (tie-breaking,
    # dropout-style noise) may ever enter a kernel wrapper
    "ops",
})

# Param / degradation-mask mutators: reachable only under the score lock
# (or from a single-writer thread, annotated at the entry point).
MUTATORS = frozenset({
    "set_degradation",
    "set_models",
    "refresh_blend_from_config",
    "promote_candidate",
    "restore_into_scorer",
})

_WALL_FNS = frozenset({
    "time", "monotonic", "perf_counter", "process_time",
    "time_ns", "monotonic_ns", "perf_counter_ns", "process_time_ns",
})
_DATETIME_FNS = frozenset({"now", "utcnow", "today"})
_NP_RANDOM_OK = frozenset({
    "default_rng", "RandomState", "Generator", "SeedSequence", "PCG64",
    "Philox", "bit_generator",
})
# stdlib `random` module-level draws that use the hidden global RNG
_RANDOM_GLOBAL_FNS = frozenset({
    "random", "randint", "randrange", "uniform", "choice", "choices",
    "shuffle", "sample", "gauss", "normalvariate", "expovariate",
    "betavariate", "gammavariate", "lognormvariate", "vonmisesvariate",
    "paretovariate", "weibullvariate", "triangular", "getrandbits",
    "randbytes", "seed",
})

# torch draws from the global generator unless given ``generator=``
_TORCH_RANDOM_FNS = frozenset({
    "rand", "randn", "randint", "randperm", "normal", "bernoulli",
    "multinomial",
})
# seeding the global generator itself (no generator= form): the host's,
# and the card's through torch.cuda
_TORCH_SEED_FNS = frozenset({"manual_seed", "seed"})
_TORCH_CUDA_SEED_FNS = frozenset({"manual_seed", "manual_seed_all", "seed",
                                  "seed_all"})
# in-place Tensor draws (and torch.nn.init's of the same names)
_TORCH_INPLACE_RANDOM = frozenset({
    "uniform_", "normal_", "random_", "bernoulli_", "exponential_",
})
# torch's blocking device->host pulls (method form, no arguments)
_TORCH_PULLS = frozenset({"cpu", "numpy", "tolist", "synchronize"})

_SNAKE_RE = re.compile(r"^[a-z][a-z0-9_]*$")
_PRAGMA_RE = re.compile(
    r"#\s*rtfd-lint:\s*allow\[([A-Za-z0-9_\-\s,]*)\](.*)$")


@dataclass
class Finding:
    rule: str
    path: str
    line: int
    col: int
    message: str

    def as_dict(self) -> Dict[str, Any]:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "col": self.col, "message": self.message}

    def __str__(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: "
                f"[{self.rule}] {self.message}")


@dataclass
class Pragma:
    path: str
    line: int            # line the pragma comment sits on
    target: int          # code line it covers
    rules: Tuple[str, ...]
    hits: int = 0


@dataclass
class Module:
    relpath: str         # package-relative, '/'-separated (e.g. "qos/plane.py")
    path: str            # display / reporting path
    source: str
    tree: ast.Module
    lines: List[str]
    # import alias sets, resolved per file
    time_names: Set[str] = field(default_factory=set)
    datetime_mod: Set[str] = field(default_factory=set)
    datetime_cls: Set[str] = field(default_factory=set)
    numpy_names: Set[str] = field(default_factory=set)
    torch_names: Set[str] = field(default_factory=set)
    random_names: Set[str] = field(default_factory=set)
    from_imports: Dict[str, str] = field(default_factory=dict)  # name -> mod

    @property
    def subsystem(self) -> Optional[str]:
        if "/" in self.relpath:
            return self.relpath.split("/", 1)[0]
        return None


def _resolve_aliases(mod: Module) -> None:
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                bound = alias.asname or alias.name.split(".")[0]
                if alias.name == "time":
                    mod.time_names.add(bound)
                elif alias.name == "datetime":
                    mod.datetime_mod.add(bound)
                elif alias.name in ("numpy", "numpy.random"):
                    mod.numpy_names.add(bound)
                elif alias.name == "torch" or alias.name.startswith("torch."):
                    mod.torch_names.add(bound)
                elif alias.name == "random":
                    mod.random_names.add(bound)
        elif isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                bound = alias.asname or alias.name
                mod.from_imports[bound] = f"{node.module}.{alias.name}"
                if node.module == "datetime" and alias.name == "datetime":
                    mod.datetime_cls.add(bound)


def _parse_pragmas(mod: Module) -> List[Pragma]:
    """Pragmas from REAL comment tokens only (a pragma-shaped substring
    inside a string literal — e.g. this linter's own messages — is not a
    pragma)."""
    pragmas: List[Pragma] = []
    try:
        tokens = list(tokenize.generate_tokens(
            io.StringIO(mod.source).readline))
    except (tokenize.TokenError, IndentationError):
        return pragmas
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _PRAGMA_RE.search(tok.string)
        if not m:
            continue
        i = tok.start[0]
        rules = tuple(r.strip() for r in m.group(1).split(",") if r.strip())
        target = i
        if mod.lines[i - 1].strip().startswith("#"):
            # comment-only pragma line: covers the next code line
            for j in range(i + 1, len(mod.lines) + 1):
                nxt = mod.lines[j - 1].strip()
                if nxt and not nxt.startswith("#"):
                    target = j
                    break
        pragmas.append(Pragma(mod.path, i, target, rules))
    return pragmas


def _load_module(path: str, relpath: str,
                 source: Optional[str] = None) -> Optional[Module]:
    if source is None:
        with open(path, encoding="utf-8") as f:
            source = f.read()
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return None
    mod = Module(relpath=relpath.replace(os.sep, "/"), path=path,
                 source=source, tree=tree, lines=source.splitlines())
    _resolve_aliases(mod)
    return mod


def _dotted(node: ast.AST) -> str:
    """Best-effort dotted-name rendering of an expression ('a.b.c')."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    elif isinstance(node, ast.Call):
        parts.append(_dotted(node.func) + "()")
    return ".".join(reversed(parts))


def _is_lockish(expr: ast.AST) -> bool:
    if isinstance(expr, ast.IfExp):
        # `with (lock if lock is not None else nullcontext())`
        return _is_lockish(expr.body) or _is_lockish(expr.orelse)
    if isinstance(expr, ast.BoolOp):
        return any(_is_lockish(v) for v in expr.values)
    name = _dotted(expr).lower()
    leaf = name.rsplit(".", 1)[-1]
    return ("lock" in leaf or leaf in ("_cv", "cv")
            or "cond" in leaf)


# --------------------------------------------------------------------- rules

def _rule_wall_clock(ctx: "Context") -> List[Finding]:
    out: List[Finding] = []
    for mod in ctx.modules:
        if mod.subsystem not in CLOCK_SUBSYSTEMS:
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            bad = None
            if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
                base = f.value.id
                if base in mod.time_names and f.attr in _WALL_FNS:
                    bad = f"time.{f.attr}()"
                elif base in mod.datetime_cls and f.attr in _DATETIME_FNS:
                    bad = f"datetime.{f.attr}()"
            elif (isinstance(f, ast.Attribute)
                  and isinstance(f.value, ast.Attribute)
                  and isinstance(f.value.value, ast.Name)
                  and f.value.value.id in mod.datetime_mod
                  and f.value.attr == "datetime"
                  and f.attr in _DATETIME_FNS):
                bad = f"datetime.datetime.{f.attr}()"
            elif isinstance(f, ast.Name):
                target = mod.from_imports.get(f.id, "")
                if target.startswith("time.") \
                        and target.split(".", 1)[1] in _WALL_FNS:
                    bad = f"{target}()"
            if bad:
                out.append(Finding(
                    "wall-clock", mod.path, node.lineno, node.col_offset,
                    f"bare {bad} in virtual-clock-capable subsystem "
                    f"'{mod.subsystem}/' — route through the injected "
                    f"clock/now seam, or annotate the genuinely wall-clock "
                    f"site with `# rtfd-lint: allow[wall-clock] <why>`"))
    return out


def _d2h_scopes(mod: Module) -> List[Tuple[ast.AST, str]]:
    """(scope node, label) pairs the d2h rule checks in this module."""
    if mod.relpath in D2H_MODULES:
        return [(mod.tree, mod.relpath)]
    wanted = D2H_FUNCTIONS.get(mod.relpath)
    if not wanted:
        return []
    scopes = []
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name in wanted:
            scopes.append((node, node.name))
    return scopes


def _d2h_pull(mod: Module, node: ast.Call) -> Optional[str]:
    """The pull shape a call is, or None."""
    f = node.func
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
            and f.value.id in mod.numpy_names and f.attr in (
                "asarray", "array", "ascontiguousarray"):
        return f"np.{f.attr}()"
    if isinstance(f, ast.Attribute) and f.attr == "synchronize" \
            and isinstance(f.value, ast.Attribute) \
            and f.value.attr == "cuda" \
            and isinstance(f.value.value, ast.Name) \
            and f.value.value.id in mod.torch_names:
        return "torch.cuda.synchronize()"
    if isinstance(f, ast.Attribute) and f.attr == "item" \
            and not node.args and not node.keywords:
        return ".item()"
    if isinstance(f, ast.Attribute) and f.attr in _TORCH_PULLS \
            and not node.args:
        return f".{f.attr}()"
    if isinstance(f, ast.Name) and f.id == "float" and node.args \
            and not isinstance(node.args[0], ast.Constant):
        return "float() on a non-literal"
    return None


def _rule_d2h(ctx: "Context") -> List[Finding]:
    out: List[Finding] = []
    for mod in ctx.modules:
        for scope, label in _d2h_scopes(mod):
            for node in ast.walk(scope):
                if not isinstance(node, ast.Call):
                    continue
                pull = _d2h_pull(mod, node)
                if pull:
                    out.append(Finding(
                        "d2h", mod.path, node.lineno, node.col_offset,
                        f"{pull} in dispatch-path scope '{label}': a "
                        f"blocking device->host pull stalls the host until "
                        f"the CUDA stream drains, which ends the overlap of "
                        f"the batches in flight (record a torch.cuda.Event "
                        f"or copy with non_blocking=True instead); move the "
                        f"pull past the dispatch section or annotate a "
                        f"provably-host value with "
                        f"`# rtfd-lint: allow[d2h] <why>`"))
    return out


def _metric_registrations(mod: Module) -> List[Tuple[str, str, int, int]]:
    """(kind, name, line, col) for every metric constructor in a module."""
    regs = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        f = node.func
        kind = None
        if isinstance(f, ast.Attribute) and f.attr in (
                "counter", "gauge", "histogram"):
            kind = f.attr
        elif isinstance(f, ast.Name) and f.id in (
                "Counter", "Gauge", "Histogram"):
            kind = f.id.lower()
        if kind is None:
            continue
        first = node.args[0]
        if isinstance(first, ast.Constant) and isinstance(first.value, str):
            regs.append((kind, first.value, node.lineno, node.col_offset))
        elif isinstance(first, ast.JoinedStr):
            # f-string metric names (cli.py validation textfile): check the
            # static prefix for snake_case only
            continue
    return regs


def _collector_counter_attrs(metrics_mod: Module) -> Dict[str, int]:
    """MetricsCollector counter attributes -> definition line."""
    attrs: Dict[str, int] = {}
    for node in ast.walk(metrics_mod.tree):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        t = node.targets[0]
        if not (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                and t.value.id == "self"):
            continue
        v = node.value
        if isinstance(v, ast.Call) and isinstance(v.func, ast.Attribute) \
                and v.func.attr == "counter":
            attrs[t.attr] = node.lineno
    return attrs


def _rule_metrics(ctx: "Context") -> List[Finding]:
    out: List[Finding] = []
    metrics_mod = None
    for mod in ctx.modules:
        if mod.relpath == "obs/metrics.py":
            metrics_mod = mod
        for kind, name, line, col in _metric_registrations(mod):
            if not _SNAKE_RE.match(name):
                out.append(Finding(
                    "metrics", mod.path, line, col,
                    f"metric name {name!r} is not snake_case"))
            if kind == "counter" and not name.endswith("_total"):
                out.append(Finding(
                    "metrics", mod.path, line, col,
                    f"counter {name!r} must end in '_total' (Prometheus "
                    f"counter convention; rate()/increase() consumers key "
                    f"on it)"))
            if kind in ("gauge", "histogram") and name.endswith("_total"):
                out.append(Finding(
                    "metrics", mod.path, line, col,
                    f"{kind} {name!r} must not claim the '_total' counter "
                    f"suffix"))
    if metrics_mod is None:
        return out
    counter_attrs = _collector_counter_attrs(metrics_mod)

    # internal writers: any Load of self.<attr> beyond the registration
    # assignment counts (the sync_* mirrors iterate (key, counter) tuples,
    # so the .inc receiver is often a local alias of the attribute)
    internal_writers: Set[str] = set()
    reg_lines = set(counter_attrs.values())
    for node in ast.walk(metrics_mod.tree):
        if isinstance(node, ast.Attribute) \
                and isinstance(node.ctx, ast.Load) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "self" \
                and node.attr in counter_attrs \
                and node.lineno not in reg_lines:
            internal_writers.add(node.attr)

    # .inc sites on collector counter attributes, per module
    writers: Dict[str, Dict[str, List[Tuple[int, int]]]] = {}
    for mod in ctx.modules:
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "inc"
                    and isinstance(node.func.value, ast.Attribute)):
                continue
            attr = node.func.value.attr
            if attr not in counter_attrs:
                continue
            if mod is metrics_mod:
                continue
            writers.setdefault(attr, {}).setdefault(
                mod.relpath, []).append((node.lineno, node.col_offset))
            # honest-counter check: a non-literal positional amount from
            # outside the collector smells like a raw cumulative total
            if node.args and not isinstance(node.args[0], ast.Constant):
                out.append(Finding(
                    "metrics", mod.path, node.lineno, node.col_offset,
                    f"counter '{attr}' incremented by a non-literal amount "
                    f"({_dotted(node.args[0]) or 'expression'}) outside "
                    f"obs/metrics.py — cumulative totals must mirror "
                    f"through a sync_* counter-delta method so the series "
                    f"stays an honest counter"))
    for attr, by_mod in sorted(writers.items()):
        if len(by_mod) > 1:
            planes = sorted(by_mod)
            for rel in planes[1:]:
                line, col = by_mod[rel][0]
                path = next(m.path for m in ctx.modules if m.relpath == rel)
                out.append(Finding(
                    "metrics", path, line, col,
                    f"counter '{attr}' is written from two planes "
                    f"({', '.join(planes)}) — one series, one writer; the "
                    f"second plane must mirror via its own sync_* seam"))
    for attr, line in sorted(counter_attrs.items()):
        if attr not in internal_writers and attr not in writers:
            out.append(Finding(
                "metrics", metrics_mod.path, line, 8,
                f"counter '{attr}' has no writer anywhere (neither a "
                f"sync_*/record_* mirror nor a plane) — dead series"))
    return out


class _LockVisitor(ast.NodeVisitor):
    """Annotates every Call with whether a lexical with-lock encloses it,
    and records blocking-op-under-lock findings."""

    def __init__(self, mod: Module, out: List[Finding]):
        self.mod = mod
        self.out = out
        self.lock_depth = 0
        self.lock_exprs: List[str] = []
        self.calls_under_lock: Set[int] = set()   # id(call node)

    def visit_With(self, node: ast.With) -> None:
        lockish = any(_is_lockish(item.context_expr) for item in node.items)
        if lockish:
            self.lock_depth += 1
            self.lock_exprs.append(
                _dotted(node.items[0].context_expr))
        self.generic_visit(node)
        if lockish:
            self.lock_depth -= 1
            self.lock_exprs.pop()

    def visit_Call(self, node: ast.Call) -> None:
        if self.lock_depth:
            self.calls_under_lock.add(id(node))
            self._check_blocking(node)
        self.generic_visit(node)

    def _check_blocking(self, node: ast.Call) -> None:
        f = node.func
        held = self.lock_exprs[-1]
        msg = None
        if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
                and f.value.id in self.mod.time_names and f.attr == "sleep":
            msg = "time.sleep() while holding a lock"
        elif isinstance(f, ast.Attribute) and f.attr in ("get", "put"):
            recv = _dotted(f.value).lower()
            leaf = recv.rsplit(".", 1)[-1]
            if ("queue" in leaf or leaf in ("q", "_q")) \
                    and not self._nonblocking(node):
                msg = (f"blocking queue .{f.attr}() on '{_dotted(f.value)}' "
                       f"while holding a lock")
        elif isinstance(f, ast.Attribute) and f.attr == "join":
            recv = _dotted(f.value).lower()
            if "thread" in recv:
                msg = f"thread join on '{_dotted(f.value)}' under a lock"
        if msg:
            self.out.append(Finding(
                "lock-order", self.mod.path, node.lineno, node.col_offset,
                f"{msg} (holding '{held}') — a blocked producer/consumer "
                f"on the other side of that lock deadlocks; release first "
                f"or use the _nowait form, or annotate with "
                f"`# rtfd-lint: allow[lock-order] <why>`"))

    @staticmethod
    def _nonblocking(node: ast.Call) -> bool:
        for kw in node.keywords:
            if kw.arg == "block" and isinstance(kw.value, ast.Constant) \
                    and kw.value.value is False:
                return True
            if kw.arg == "timeout" and isinstance(kw.value, ast.Constant) \
                    and kw.value.value == 0:
                return True
        if node.args and isinstance(node.args[0], ast.Constant) \
                and node.args[0].value is False:
            return True
        return False


@dataclass
class _FuncInfo:
    mod: Module
    qualname: str
    node: ast.AST
    visitor: _LockVisitor


def _index_functions(ctx: "Context") -> Dict[str, List[_FuncInfo]]:
    """simple name -> defs across the package, with lock annotations."""
    index: Dict[str, List[_FuncInfo]] = {}
    for mod in ctx.modules:
        visitor = _LockVisitor(mod, ctx.lock_findings)
        visitor.visit(mod.tree)
        ctx.lock_visitors[mod.relpath] = visitor

        class _FnCollector(ast.NodeVisitor):
            def __init__(self) -> None:
                self.stack: List[str] = []

            def visit_ClassDef(self, node: ast.ClassDef) -> None:
                self.stack.append(node.name)
                self.generic_visit(node)
                self.stack.pop()

            def _fn(self, node) -> None:
                qual = ".".join(self.stack + [node.name])
                index.setdefault(node.name, []).append(
                    _FuncInfo(mod, qual, node, visitor))
                self.stack.append(node.name)
                self.generic_visit(node)
                self.stack.pop()

            visit_FunctionDef = _fn
            visit_AsyncFunctionDef = _fn

        _FnCollector().visit(mod.tree)
    return index


def _index_calls(ctx: "Context") -> None:
    """One walk of every module: call sites by callee name (``f(...)`` and
    ``x.f(...)`` both under ``f``, in module then walk order), and each
    module's function definitions in the function index's order."""
    for mod in ctx.modules:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if isinstance(f, ast.Attribute):
                ctx.call_index.setdefault(f.attr, []).append((mod, node))
            elif isinstance(f, ast.Name):
                ctx.call_index.setdefault(f.id, []).append((mod, node))
    for infos in ctx.func_index.values():
        for info in infos:
            ctx.funcs_by_module.setdefault(id(info.mod), []).append(info)


def _enclosing_function(ctx: "Context", mod: Module, line: int
                        ) -> Optional[_FuncInfo]:
    """The innermost definition in ``mod`` whose lines hold ``line`` (the
    first of the index's order on a tie)."""
    key = (id(mod), line)
    if key in ctx.enclosing_cache:
        return ctx.enclosing_cache[key]
    best: Optional[_FuncInfo] = None
    for info in ctx.funcs_by_module.get(id(mod), ()):
        node = info.node
        end = getattr(node, "end_lineno", node.lineno)
        if node.lineno <= line <= end:
            if best is None or node.lineno > best.node.lineno:
                best = info
    ctx.enclosing_cache[key] = best
    return best


def _call_sites(name: str, ctx: "Context"
                ) -> List[Tuple[Module, ast.Call]]:
    return ctx.call_index.get(name, [])


def _has_lock_kwarg(node: ast.Call) -> bool:
    for kw in node.keywords:
        if kw.arg == "lock" and not (
                isinstance(kw.value, ast.Constant)
                and kw.value.value is None):
            return True
    return False


def _rule_lock_order(ctx: "Context") -> List[Finding]:
    out: List[Finding] = list(ctx.lock_findings)   # blocking-op findings

    def unlocked_entries(name: str, depth: int,
                         seen: Set[str]) -> List[Tuple[Module, ast.Call, str]]:
        """Package entry call sites that reach `name` without a lock.

        Returns (module, call node, path-string) triples at the TOP of
        each unlocked chain — that is where the pragma or the fix goes."""
        if depth <= 0 or name in seen:
            return []
        seen = seen | {name}
        entries: List[Tuple[Module, ast.Call, str]] = []
        for mod, call in _call_sites(name, ctx):
            visitor = ctx.lock_visitors.get(mod.relpath)
            if visitor is not None and id(call) in visitor.calls_under_lock:
                continue                      # held lexically: fine
            if _has_lock_kwarg(call):
                continue                      # lock threaded through
            if ctx.consume_pragma(mod.path, call.lineno, "lock-order"):
                # a mid-chain single-writer waiver collapses every chain
                # that flows through this call site
                continue
            caller = _enclosing_function(ctx, mod, call.lineno)
            if caller is None:
                entries.append((mod, call, name))
                continue
            ups = unlocked_entries(caller.node.name, depth - 1, seen)
            if ups:
                entries.extend(
                    (m, c, f"{p} -> {name}") for m, c, p in ups)
            elif not _call_sites(caller.node.name, ctx):
                # no package caller at all (external/thread entry): the
                # chain surfaces here
                entries.append((mod, call, f"{caller.qualname} -> {name}"))
            # else: every caller chain held a lock — fine
        return entries

    reported: Set[Tuple[str, int, str]] = set()
    for mutator in sorted(MUTATORS):
        # no definition-present gate: the mutators are a fixed contract
        # (FraudScorer/checkpoint surface) and partial lint contexts — a
        # single file, the corpus tests — must still see their call sites
        for mod, call, path in unlocked_entries(mutator, 6, set()):
            key = (mod.path, call.lineno, mutator)
            if key in reported:
                continue
            reported.add(key)
            out.append(Finding(
                "lock-order", mod.path, call.lineno, call.col_offset,
                f"param/degradation mutation '{mutator}' is reachable "
                f"here without the score lock (chain: {path}) — hold the "
                f"score lock around the mutation, pass lock=, or annotate "
                f"a single-writer entry point with "
                f"`# rtfd-lint: allow[lock-order] <why>`"))
    return out


def _torch_global_draw(mod: Module, node: ast.Call) -> Optional[str]:
    """The torch global-generator draw a call is, or None: a draw with a
    ``generator=`` (a seeded ``torch.Generator``) is fine."""
    f = node.func
    if any(kw.arg == "generator" for kw in node.keywords):
        return None
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name) \
            and f.value.id in mod.torch_names:
        if f.attr in _TORCH_RANDOM_FNS:
            return f"global-RNG torch.{f.attr}()"
        if f.attr in _TORCH_SEED_FNS:
            return f"global generator torch.{f.attr}()"
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Attribute) \
            and f.value.attr == "cuda" \
            and isinstance(f.value.value, ast.Name) \
            and f.value.value.id in mod.torch_names \
            and f.attr in _TORCH_CUDA_SEED_FNS:
        return f"global generator torch.cuda.{f.attr}()"
    if isinstance(f, ast.Attribute) and f.attr in _TORCH_INPLACE_RANDOM:
        return f"global-RNG in-place .{f.attr}()"
    if isinstance(f, ast.Name):
        target = mod.from_imports.get(f.id, "")
        if target.startswith("torch.") and target.count(".") == 1 \
                and target.split(".", 1)[1] in _TORCH_RANDOM_FNS:
            return f"global-RNG {target}()"
    return None


def _rule_determinism(ctx: "Context") -> List[Finding]:
    out: List[Finding] = []
    for mod in ctx.modules:
        base = os.path.basename(mod.relpath)
        if not (mod.relpath.startswith("sim/") or "drill" in base
                or mod.relpath in DETERMINISM_MODULES
                or mod.subsystem in DETERMINISM_SUBSYSTEMS):
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            msg = None
            if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
                if f.value.id in mod.random_names \
                        and f.attr in _RANDOM_GLOBAL_FNS:
                    msg = f"global-RNG random.{f.attr}()"
            if isinstance(f, ast.Attribute) \
                    and isinstance(f.value, ast.Attribute) \
                    and isinstance(f.value.value, ast.Name) \
                    and f.value.value.id in mod.numpy_names \
                    and f.value.attr == "random" \
                    and f.attr not in _NP_RANDOM_OK:
                msg = f"global-RNG np.random.{f.attr}()"
            if msg is None:
                msg = _torch_global_draw(mod, node)
            if msg:
                out.append(Finding(
                    "determinism", mod.path, node.lineno, node.col_offset,
                    f"{msg} in a deterministic module — drills and the "
                    f"simulator must replay bit-identically; draw from a "
                    f"seeded np.random.default_rng(seed) / "
                    f"random.Random(seed) / torch.Generator (passed as "
                    f"generator=) instance instead"))
    return out


RULES: Dict[str, Any] = {
    "wall-clock": _rule_wall_clock,
    "d2h": _rule_d2h,
    "metrics": _rule_metrics,
    "lock-order": _rule_lock_order,
    "determinism": _rule_determinism,
    # pragma-hygiene runs structurally in run_lint (it needs the
    # suppression outcome of every other rule)
}
KNOWN_RULES = frozenset(RULES) | {"pragma-hygiene"}


@dataclass
class Context:
    modules: List[Module]
    pragmas: List[Pragma] = field(default_factory=list)
    lock_findings: List[Finding] = field(default_factory=list)
    lock_visitors: Dict[str, _LockVisitor] = field(default_factory=dict)
    func_index: Dict[str, List[_FuncInfo]] = field(default_factory=dict)
    call_index: Dict[str, List[Tuple[Module, ast.Call]]] = field(
        default_factory=dict)
    funcs_by_module: Dict[int, List[_FuncInfo]] = field(default_factory=dict)
    enclosing_cache: Dict[Tuple[int, int], Optional[_FuncInfo]] = field(
        default_factory=dict)
    pragma_index: Dict[Tuple[str, int], List[Pragma]] = field(
        default_factory=dict)

    def consume_pragma(self, path: str, line: int, rule: str) -> bool:
        hit = False
        for p in self.pragma_index.get((path, line), ()):
            if rule in p.rules:
                p.hits += 1
                hit = True
        return hit


def _run(ctx: Context) -> List[Finding]:
    for mod in ctx.modules:
        ctx.pragmas.extend(_parse_pragmas(mod))
    for p in ctx.pragmas:
        ctx.pragma_index.setdefault((p.path, p.target), []).append(p)
        if p.line != p.target:
            ctx.pragma_index.setdefault((p.path, p.line), []).append(p)
    ctx.func_index = _index_functions(ctx)
    _index_calls(ctx)

    raw: List[Finding] = []
    for fn in RULES.values():
        raw.extend(fn(ctx))

    kept: List[Finding] = []
    for f in raw:
        if not ctx.consume_pragma(f.path, f.line, f.rule):
            kept.append(f)

    seen_pragmas: Set[int] = set()
    for p in ctx.pragmas:
        if id(p) in seen_pragmas:
            continue
        seen_pragmas.add(id(p))
        unknown = [r for r in p.rules if r not in KNOWN_RULES]
        if not p.rules or unknown:
            kept.append(Finding(
                "pragma-hygiene", p.path, p.line, 0,
                f"pragma names unknown rule(s) "
                f"{unknown or ['<empty>']} — known: "
                f"{', '.join(sorted(KNOWN_RULES - {'pragma-hygiene'}))}"))
        elif p.hits == 0:
            kept.append(Finding(
                "pragma-hygiene", p.path, p.line, 0,
                f"stale pragma allow[{','.join(p.rules)}]: it no longer "
                f"suppresses any finding — the code it waived was fixed "
                f"or moved; delete the pragma"))
    kept.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return kept


# ----------------------------------------------------------------- frontends

def _package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _iter_package_files(root: str) -> Iterable[Tuple[str, str]]:
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in sorted(dirnames)
                       if d not in ("__pycache__",)]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                full = os.path.join(dirpath, fn)
                yield full, os.path.relpath(full, root)


def lint_paths(paths: Optional[Sequence[str]] = None) -> List[Finding]:
    """Lint the port's package tree; ``paths`` filters the REPORT, not the
    scope.

    The cross-module rules (metrics one-writer, the lock-order call-graph)
    and the subsystem scoping are only correct with the whole package in
    context, so the full tree is always loaded and analyzed; explicit
    files/directories merely restrict which findings are returned. A path
    outside the package tree contributes nothing — in-memory corpus
    linting goes through :func:`lint_source` instead.
    """
    root = _package_root()
    modules: List[Module] = []
    for full, rel in _iter_package_files(root):
        m = _load_module(full, rel)
        if m is not None:
            modules.append(m)
    findings = _run(Context(modules=modules))
    if not paths:
        return findings
    targets: Set[str] = set()
    for p in paths:
        if os.path.isdir(p):
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = [d for d in dirnames if d != "__pycache__"]
                for fn in filenames:
                    if fn.endswith(".py"):
                        targets.add(os.path.abspath(
                            os.path.join(dirpath, fn)))
        else:
            targets.add(os.path.abspath(p))
    return [f for f in findings if os.path.abspath(f.path) in targets]


def lint_source(source: str, relpath: str,
                extra: Optional[Dict[str, str]] = None) -> List[Finding]:
    """Lint in-memory source as if it lived at ``relpath`` inside the
    package — the seeded-violation corpus tests use this so no bad code
    ever has to exist on disk. ``extra`` maps more relpaths to sources
    (for cross-module rules)."""
    modules = []
    m = _load_module(relpath, relpath, source=source)
    if m is not None:
        modules.append(m)
    for rel, src in (extra or {}).items():
        em = _load_module(rel, rel, source=src)
        if em is not None:
            modules.append(em)
    return _run(Context(modules=modules))


def format_findings(findings: Sequence[Finding], fmt: str = "text") -> str:
    if fmt == "json":
        return json.dumps({
            "findings": [f.as_dict() for f in findings],
            "count": len(findings),
            "rules": sorted(KNOWN_RULES),
            "clean": not findings,
        }, indent=2)
    if not findings:
        return "lint: clean (0 findings)"
    lines = [str(f) for f in findings]
    lines.append(f"lint: {len(findings)} finding(s)")
    return "\n".join(lines)


def run_lint(paths: Optional[Sequence[str]] = None,
             fmt: str = "text") -> Tuple[int, str]:
    """(exit_code, rendered output) — the CLI seam."""
    findings = lint_paths(paths)
    return (1 if findings else 0), format_findings(findings, fmt)
