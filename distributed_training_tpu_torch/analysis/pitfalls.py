"""AST-level pitfall lint rules (DTT0xx) for the port, as a registry
(port of ``analysis/pitfalls.py``).

Each rule encodes a discipline the port otherwise keeps only by
convention. The codes, the registry, the ``# noqa`` scoping and the file
walk are the JAX package's; the rules are rescoped to the port's paths
and rewritten in their torch forms:

- DTT001 bare jsonl emission outside the telemetry sink.
- DTT002 silent broad exception swallow.
- DTT003 host sync in the trainer's step loop: ``.item()``,
  ``.tolist()``, ``.cpu()``, ``.numpy()``, ``float/int/bool(tensor)``,
  ``torch.cuda.synchronize`` — one blocked host stalls every card.
- DTT004 collective-cadence divergence: a ``torch.distributed`` call, or
  one of the port's collective helpers, lexically guarded by a
  host-local condition (``is_coordinator``, a rank test, the wall clock)
  deadlocks the world.
- DTT007 hard-coded world size in the trainer/data/telemetry paths.
- DTT008 a placement with axis-name literals in ``models/`` or
  ``train/``: layouts come from ``parallel/strategy.py``'s rules or a
  resolved plan (``parallel/planner.py``).
- DTT009 unseeded RNG in ``data/``: ``torch.rand*``/``randperm``/... or an
  in-place sampler without ``generator=``, unseeded numpy generators,
  module-level ``np.random.*`` samplers, stdlib ``random.*``.
- DTT010 host sync in ``serving/`` outside the engine's designated sync
  helpers (``Engine._fetch_host`` and the KV export/import paths).
- DTT011 serving params rebinding outside ``Engine.__init__``/
  ``Engine.swap_weights`` (and ``WeightStore.__init__``).

Not carried: DTT005 (PRNG key reuse) and DTT006 (undonated jitted step)
are JAX's. Torch draws from stateful generators (DTT009 covers the data
pipeline's), and an eager step updates its tensors in place, so there is
no buffer to donate.

IMPORT CONTRACT: stdlib only, so the table runs without torch.
Suppression uses flake8 ``# noqa`` scoping: a bare ``# noqa`` on the
flagged line suppresses everything, ``# noqa: DTT003`` only that rule.
``tests/`` is exempt from every rule.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass
from typing import Callable

# Repo root when this file sits at <repo>/distributed_training_tpu_torch/
# analysis/pitfalls.py; callers may override per-call.
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
PACKAGE = "distributed_training_tpu_torch"

# Directories never linted (generated artifacts, caches, postmortem
# evidence): the JAX table's set.
SKIP_DIRS = {".git", "__pycache__", "outputs", "_build", ".venv",
             "state", "evidence", "postmortem"}

NOT_CARRIED = {
    "DTT005": "PRNG key reuse: JAX's keys; torch samples from stateful "
              "generators (DTT009 covers the data pipeline's)",
    "DTT006": "undonated jitted train step: an eager step updates its "
              "tensors in place, so there is no buffer to donate",
}


def _p(*parts: str) -> str:
    return os.path.join(PACKAGE, *parts)


def iter_py_files(root: str | None = None):
    """Every lintable .py file under ``root`` (default: the port's
    package)."""
    for dirpath, dirnames, filenames in os.walk(
            root or os.path.join(REPO, PACKAGE)):
        dirnames[:] = [d for d in dirnames if d not in SKIP_DIRS]
        for name in filenames:
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)

# ---------------------------------------------------------------------------
# Registry plumbing
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Rule:
    code: str
    name: str
    summary: str
    check: Callable


RULES: dict[str, Rule] = {}


def _rule(code: str, name: str, summary: str):
    def deco(fn):
        RULES[code] = Rule(code, name, summary, fn)
        return fn
    return deco


class FileContext:
    """One parsed file, shared across rules (parse once, lint many)."""

    def __init__(self, path: str, rel: str, text: str,
                 tree: ast.AST | None = None):
        self.path = path
        self.rel = rel
        self.text = text
        self.lines = text.splitlines()
        self.tree = tree if tree is not None else ast.parse(text)
        self._parents: dict | None = None

    @property
    def parents(self) -> dict:
        if self._parents is None:
            self._parents = {
                child: parent
                for parent in ast.walk(self.tree)
                for child in ast.iter_child_nodes(parent)}
        return self._parents

    def ancestors(self, node):
        while node in self.parents:
            node = self.parents[node]
            yield node

    def enclosing_fn(self, node):
        for anc in self.ancestors(node):
            if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return anc
        return None

    def in_scope(self, prefixes) -> bool:
        return any(self.rel.startswith(p + os.sep) or self.rel == p
                   for p in prefixes)


def noqa_allows(lines: list[str], lineno: int, code: str) -> bool:
    """flake8 noqa scoping: a bare ``# noqa`` suppresses everything,
    ``# noqa: CODE[,CODE]`` only the named codes."""
    if not (0 < lineno <= len(lines)):
        return False
    m = re.search(r"#\s*noqa(?::\s*([A-Z0-9, ]+))?", lines[lineno - 1])
    return bool(m and (m.group(1) is None or code in m.group(1)))


def check_file_rules(path: str, repo: str | None = None,
                     text: str | None = None,
                     tree: ast.AST | None = None) -> list[str]:
    """Run every registered rule over one file; returns formatted
    ``rel:line: CODE message`` problems (noqa-filtered). Files under
    ``tests/`` are exempt wholesale; syntax errors yield no findings
    (the flake8 pass owns E999)."""
    repo = repo or REPO
    rel = os.path.relpath(path, repo)
    if rel.startswith("tests" + os.sep):
        return []
    if text is None:
        with open(path, encoding="utf-8") as f:
            text = f.read()
    try:
        ctx = FileContext(path, rel, text, tree)
    except SyntaxError:
        return []
    problems: list[str] = []
    for code in sorted(RULES):
        for lineno, msg in RULES[code].check(ctx):
            if noqa_allows(ctx.lines, lineno, code):
                continue
            problems.append(f"{rel}:{lineno}: {code} {msg}")
    return problems


def run_rules(repo: str | None = None) -> list[str]:
    """Every rule over every file of the port's package under ``repo``."""
    repo = repo or REPO
    problems: list[str] = []
    for path in iter_py_files(os.path.join(repo, PACKAGE)):
        problems += check_file_rules(path, repo=repo)
    return problems


def _terminal_name(node) -> str:
    """The rightmost identifier of a Name/Attribute chain ('' else)."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return ""


def _attr_chain(node) -> list[str]:
    """['torch', 'cuda', 'synchronize'] for ``torch.cuda.synchronize``
    (best effort; empty when the chain roots in a call/subscript)."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return list(reversed(parts))
    return []


def _names_in(node) -> set[str]:
    """Every Name id and Attribute attr in a subtree."""
    out: set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            out.add(n.id)
        elif isinstance(n, ast.Attribute):
            out.add(n.attr)
    return out


def _is_constant_cast(node: ast.Call) -> bool:
    return all(isinstance(a, ast.Constant) for a in node.args)


# ---------------------------------------------------------------------------
# DTT001 — bare jsonl emission
# ---------------------------------------------------------------------------

# The only modules allowed to open a jsonl stream for writing: the event
# sink and the metrics logger.
JSONL_SINKS = {_p("telemetry", "events.py"), _p("utils", "metrics.py")}
_WRITE_CHARS = set("wax+")


@_rule("DTT001", "bare-jsonl-write",
       "write-mode open() of a *jsonl* stream outside the event sink")
def _check_jsonl_sink(ctx: FileContext):
    """A write-mode ``open`` of a ``*jsonl*`` stream outside the
    telemetry/metrics sinks skips host tagging, and the multi-host
    aggregator mis-attributes the records."""
    if ctx.rel in JSONL_SINKS:
        return
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "open" and node.args):
            continue
        mode = node.args[1] if len(node.args) >= 2 else None
        for kw in node.keywords:
            if kw.arg == "mode":
                mode = kw.value
        if not (isinstance(mode, ast.Constant)
                and isinstance(mode.value, str)
                and set(mode.value) & _WRITE_CHARS):
            continue
        target = ast.get_source_segment(ctx.text, node.args[0]) or ""
        if "jsonl" not in target.lower():
            continue
        yield (node.lineno,
               "write-mode open() of a jsonl stream outside the "
               "telemetry sink — emit through telemetry/events.py "
               "(host tagging)")


# ---------------------------------------------------------------------------
# DTT002 — silent broad exception swallow
# ---------------------------------------------------------------------------

_BROAD_EXC_NAMES = {"Exception", "BaseException"}


@_rule("DTT002", "silent-broad-swallow",
       "broad `except ...: pass` discards failure evidence")
def _check_silent_swallow(ctx: FileContext):
    """``except Exception: pass`` (or a bare except / BaseException)
    discards failure evidence. Narrow handlers are fine — naming the
    exception is the evidence the swallow was a decision."""
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        if not all(isinstance(s, ast.Pass) for s in node.body):
            continue
        t = node.type
        names = []
        if t is None:
            names = ["<bare>"]
        elif isinstance(t, ast.Name):
            names = [t.id]
        elif isinstance(t, ast.Tuple):
            names = [e.id for e in t.elts if isinstance(e, ast.Name)]
        if not any(n == "<bare>" or n in _BROAD_EXC_NAMES
                   for n in names):
            continue
        yield (node.lineno,
               "silent broad exception swallow (`except Exception: "
               "pass`) — narrow it, log a breadcrumb, or noqa with "
               "justification")


# ---------------------------------------------------------------------------
# DTT003 — host sync in the hot step path
# ---------------------------------------------------------------------------

# Functions that ARE the hot step path, per file: the trainer's step,
# its loop and evaluation (``make_train_step``'s inner ``train_step``
# included). Deliberate syncs carry `# noqa: DTT003` with their reason.
DTT003_HOT_PATHS: dict[str, set[str]] = {
    _p("train", "trainer.py"): {"train_step", "_run_epoch", "evaluate"},
}
_HOST_SYNC_ATTRS = {"item", "tolist", "cpu", "numpy", "synchronize"}
_HOST_SYNC_CASTS = {"float", "int", "bool"}


def _host_syncs(fn):
    """(lineno, what) for each host-sync call in ``fn``'s body."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        name = _terminal_name(node.func)
        if isinstance(node.func, ast.Attribute) and name in _HOST_SYNC_ATTRS:
            yield node.lineno, name
        elif (isinstance(node.func, ast.Name) and name in _HOST_SYNC_CASTS
              and node.args and not _is_constant_cast(node)):
            yield node.lineno, name


@_rule("DTT003", "hot-path-host-sync",
       "host-device sync inside the hot step path")
def _check_hot_path_sync(ctx: FileContext):
    """``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` /
    ``float(tensor)`` / ``torch.cuda.synchronize`` inside the trainer's
    step loop wait for the card's queue to drain, once a step (the
    design is ONE host sync per epoch). Casts of constants are fine."""
    hot = DTT003_HOT_PATHS.get(ctx.rel)
    if not hot:
        return
    for fn in ast.walk(ctx.tree):
        if not (isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                and fn.name in hot):
            continue
        for lineno, name in _host_syncs(fn):
            yield (lineno,
                   f"host sync `{name}(...)` in hot step path "
                   f"`{fn.name}` — keep device values on device "
                   "(one sync per epoch; noqa deliberate syncs)")


# ---------------------------------------------------------------------------
# DTT004 — collective cadence must not be host-local
# ---------------------------------------------------------------------------

# torch.distributed's collectives and the port's helpers that launch
# them: every process of the group must reach them at the same point.
_DTT004_COLLECTIVES = {
    "all_reduce", "all_gather", "all_gather_into_tensor",
    "all_gather_object", "reduce_scatter", "reduce_scatter_tensor",
    "broadcast", "broadcast_object_list", "barrier", "monitored_barrier",
    "all_to_all", "all_to_all_single", "batch_isend_irecv", "gather",
    "scatter", "reduce",
    # The port's helpers (parallel/fsdp.py, parallel/planner.py,
    # utils/diagnostics.py, parallel/pipeline.py).
    "average_grads", "mean_over_data", "gather_full", "gather_shards",
    "all_gather_dims", "reduce_scatter_dims", "all_agree",
    "replica_divergence", "broadcast_from_last",
}
_DTT004_HOST_LOCAL = {
    "is_coordinator", "process_index", "rank", "get_rank",
    "should_stop", "perf_counter", "monotonic", "time", "time_ns",
    "random", "getrandbits", "uuid4", "environ", "getenv", "gethostname",
}


@_rule("DTT004", "host-local-collective-guard",
       "collective reachable under a host-local condition")
def _check_collective_cadence(ctx: FileContext):
    """A collective guarded by a condition that differs across processes
    (coordinator checks, rank tests, the wall clock, the environment)
    deadlocks the world: some processes enter it, the rest never
    arrive. Cadence must be a pure function of the step, or of config
    identical on every process. Lexical check only."""
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call)
                and _terminal_name(node.func) in _DTT004_COLLECTIVES):
            continue
        for anc in ctx.ancestors(node):
            if not isinstance(anc, (ast.If, ast.While, ast.IfExp)):
                continue
            markers = _names_in(anc.test) & _DTT004_HOST_LOCAL
            if markers:
                yield (node.lineno,
                       f"collective `{_terminal_name(node.func)}` "
                       "reachable under host-local condition "
                       f"({', '.join(sorted(markers))}) — cadence "
                       "must be a pure function of global_step "
                       "(deadlock risk)")
                break


# ---------------------------------------------------------------------------
# DTT007 — hard-coded world size in elastic hot paths
# ---------------------------------------------------------------------------

_DTT007_WORLD_NAMES = {
    "process_count", "num_processes", "world_size", "get_world_size",
    "num_hosts", "host_count", "num_shards", "data_shard_count",
    "shard_count", "nproc",
}
DTT007_SCOPED = (_p("train"), _p("data"), _p("telemetry"))
_DTT007_BODY_RE = re.compile(r"(^|_)(hosts?|shards?)(_|$)")


@_rule("DTT007", "hard-coded-world-size",
       "world-size/process-count literal in an elastic hot path")
def _check_world_size_literal(ctx: FileContext):
    """``process_count == 2`` / ``num_shards >= 4`` / ``for h in
    range(4): ... host_dirs[h] ...`` bake one world size into code the
    elastic supervisor re-forms at another size. Comparisons against
    0/1 stay legal."""
    if not ctx.in_scope(DTT007_SCOPED):
        return
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Compare):
            sides = [node.left] + list(node.comparators)
            names = {_terminal_name(s.func) if isinstance(s, ast.Call)
                     else _terminal_name(s) for s in sides}
            lits = [s.value for s in sides
                    if isinstance(s, ast.Constant)
                    and isinstance(s.value, int)
                    and not isinstance(s.value, bool)]
            world = names & _DTT007_WORLD_NAMES
            if world and any(v >= 2 for v in lits):
                yield (node.lineno,
                       f"`{sorted(world)[0]}` compared against a "
                       "world-size literal — elastic runs resize the "
                       "world mid-run; derive from the runtime (or "
                       "noqa a deliberate pin)")
        elif (isinstance(node, ast.For)
              and isinstance(node.iter, ast.Call)
              and _terminal_name(node.iter.func) == "range"
              and len(node.iter.args) == 1
              and isinstance(node.iter.args[0], ast.Constant)
              and isinstance(node.iter.args[0].value, int)
              and node.iter.args[0].value >= 2):
            body_names = set()
            for stmt in node.body:
                body_names |= _names_in(stmt)
            hostish = {n for n in body_names
                       if _DTT007_BODY_RE.search(n.lower())}
            if hostish:
                yield (node.lineno,
                       f"`range({node.iter.args[0].value})` iterated "
                       "over host/shard-indexed state "
                       f"({sorted(hostish)[0]}) — a fixed world size; "
                       "derive the count from the runtime")


# ---------------------------------------------------------------------------
# DTT008 — placement axis literals outside the sharding map
# ---------------------------------------------------------------------------

DTT008_SCOPED = (_p("models"), _p("train"))
_PLACEMENT_NAMES = {"Placement", "PartitionSpec", "P"}


def _axis_literals(arg) -> list[str]:
    """String constants in an argument, or in the tuples/lists it nests
    (a ``Placement``'s ``((dim, ("fsdp",)),)``), not inside calls or
    expressions."""
    if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
        return [arg.value]
    if isinstance(arg, (ast.Tuple, ast.List)):
        return [lit for e in arg.elts for lit in _axis_literals(e)]
    return []


@_rule("DTT008", "raw-placement-literal",
       "placement axis-name literal outside the sharding map")
def _check_raw_placement(ctx: FileContext):
    """A ``Placement(...)`` (the port's layout record) with mesh-axis
    literals in models/ or train/ hard-codes a layout decision that
    ``parallel/strategy.py``'s rules (or a resolved plan,
    ``parallel/planner.py``) own."""
    if not ctx.in_scope(DTT008_SCOPED):
        return
    for node in ast.walk(ctx.tree):
        if not (isinstance(node, ast.Call)
                and _terminal_name(node.func) in _PLACEMENT_NAMES):
            continue
        literals = [lit for arg in list(node.args)
                    + [kw.value for kw in node.keywords]
                    for lit in _axis_literals(arg)]
        if literals:
            yield (node.lineno,
                   f"placement with axis-name literal(s) "
                   f"{sorted(set(literals))} outside the named sharding "
                   "map — route the layout through parallel/strategy.py "
                   "rules or a resolved plan (parallel/planner.py)")


# ---------------------------------------------------------------------------
# DTT009 — unseeded RNG state inside the data pipeline
# ---------------------------------------------------------------------------

DTT009_SCOPED = (_p("data"),)
_DTT009_NP_OK = {"default_rng", "Generator", "SeedSequence", "Philox",
                 "PCG64", "PCG64DXSM", "MT19937", "SFC64",
                 "BitGenerator"}
_DTT009_STDLIB = {"random", "randint", "randrange", "uniform",
                  "choice", "choices", "sample", "shuffle", "seed",
                  "getrandbits", "gauss", "betavariate",
                  "expovariate", "normalvariate", "triangular",
                  "randbytes"}
# torch samplers that draw from the global generator unless given
# ``generator=``; the in-place ``Tensor`` samplers likewise.
_DTT009_TORCH = {"rand", "randn", "randint", "randperm", "rand_like",
                 "randn_like", "randint_like", "normal", "bernoulli",
                 "multinomial", "poisson"}
_DTT009_TORCH_INPLACE = {"random_", "uniform_", "normal_", "bernoulli_",
                         "exponential_", "geometric_", "cauchy_",
                         "log_normal_"}


@_rule("DTT009", "unseeded-rng-in-data",
       "RNG without an explicit seed inside the data pipeline")
def _check_unseeded_rng(ctx: FileContext):
    """Samplers that draw from hidden, unserializable RNG state inside
    ``data/``: ``torch.rand*``/``randperm``/... or an in-place sampler
    without ``generator=``, ``np.random.default_rng()`` with no seed,
    module-level ``np.random.*`` samplers, stdlib ``random.*``. The
    pipeline's position must round-trip through checkpoint meta as
    integers, or a resume replays or skips samples."""
    if not ctx.in_scope(DTT009_SCOPED):
        return
    from_names: dict = {}
    module_aliases = set()
    for node in ast.walk(ctx.tree):
        if (isinstance(node, ast.ImportFrom)
                and node.module == "numpy.random"):
            for a in node.names:
                from_names[a.asname or a.name] = a.name
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "numpy.random" and a.asname:
                    module_aliases.add(a.asname)
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        chain = _attr_chain(node.func)
        attr = _terminal_name(node.func)
        seeded_gen = any(kw.arg == "generator" for kw in node.keywords)
        if attr in _DTT009_TORCH_INPLACE and isinstance(
                node.func, ast.Attribute) and not seeded_gen:
            yield (node.lineno,
                   f"in-place sampler `{attr}(...)` without generator= "
                   "draws from torch's global generator — pass a seeded "
                   "torch.Generator")
            continue
        if not chain:
            continue
        if (len(chain) == 2 and chain[0] == "torch"
                and attr in _DTT009_TORCH and not seeded_gen):
            yield (node.lineno,
                   f"torch.{attr}(...) without generator= draws from "
                   "torch's global generator — pass a seeded "
                   "torch.Generator")
            continue
        if len(chain) == 1 and chain[0] in from_names:
            attr = from_names[chain[0]]
            np_random = True
        else:
            np_random = (
                (len(chain) >= 3 and chain[0] in ("np", "numpy")
                 and chain[1] == "random")
                or (len(chain) == 2 and chain[0] in module_aliases))
        if attr == "default_rng" and (np_random or "random" in chain):
            def _non_none(v):
                return not (isinstance(v, ast.Constant)
                            and v.value is None)
            seeded = ([a for a in node.args if _non_none(a)]
                      or [kw for kw in node.keywords
                          if kw.arg is None or _non_none(kw.value)])
            if not seeded:
                yield (node.lineno,
                       "np.random.default_rng() without an explicit "
                       "seed — unserializable pipeline position; "
                       "derive the seed from config/state integers")
        elif np_random and attr not in _DTT009_NP_OK:
            yield (node.lineno,
                   f"module-level np.random.{attr}(...) draws "
                   "from hidden global RNG state — construct a "
                   "seeded Generator instead")
        elif (len(chain) == 2 and chain[0] == "random"
              and chain[1] in _DTT009_STDLIB):
            yield (node.lineno,
                   f"stdlib random.{chain[1]}(...) draws from hidden "
                   "global RNG state — construct a seeded "
                   "np.random.Generator instead")


# ---------------------------------------------------------------------------
# DTT010 — host sync in serving hot paths
# ---------------------------------------------------------------------------

# Every module under serving/ sits between a request and its tokens.
# The resident decode burst syncs the host ONCE per burst; the only
# functions allowed to bring device values to the host are the
# designated sync helpers below (or a line with `# noqa: DTT010` and
# its reason).
DTT010_SCOPED = (_p("serving"),)
DTT010_SYNC_HELPERS: dict[str, set[str]] = {
    _p("serving", "engine.py"): {"_fetch_host"},
    _p("serving", "disagg.py"): {"export_kv_batch", "import_kv_batch"},
    _p("serving", "kv_cache.py"): {"gather_pages"},
}


@_rule("DTT010", "serving-hot-path-host-sync",
       "host-device sync in serving/ outside a designated sync helper")
def _check_serving_host_sync(ctx: FileContext):
    """``.item()`` / ``.tolist()`` / ``.cpu()`` / ``.numpy()`` /
    ``synchronize`` / ``np.asarray(tensor)`` in ``serving/`` outside the
    designated sync helpers forces an extra host round-trip per call
    site. Host-side conversions of host data use ``np.array`` (a copy,
    never a sync)."""
    if not ctx.in_scope(DTT010_SCOPED):
        return
    allowed = DTT010_SYNC_HELPERS.get(ctx.rel, set())
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = _terminal_name(node.func)
        if name == "asarray":
            chain = _attr_chain(node.func)
            if not chain or chain[0] not in ("np", "numpy"):
                continue
        elif not (isinstance(node.func, ast.Attribute)
                  and name in _HOST_SYNC_ATTRS):
            continue
        fn = ctx.enclosing_fn(node)
        if fn is not None and fn.name in allowed:
            continue
        where = f"`{fn.name}`" if fn is not None else "module scope"
        yield (node.lineno,
               f"host sync `{name}(...)` in serving hot path {where} "
               "— route fetches through the designated sync helper "
               "(Engine._fetch_host / the KV export-import); host-side "
               "conversions use np.array")


# ---------------------------------------------------------------------------
# DTT011 — params rebinding outside swap_weights
# ---------------------------------------------------------------------------

DTT011_SCOPED = (_p("serving"),)
DTT011_ALLOWED: dict[str, set[str]] = {
    _p("serving", "engine.py"): {"__init__", "swap_weights"},
    _p("serving", "disagg.py"): {"__init__"},
}


@_rule("DTT011", "serving-params-rebinding",
       "serving weights rebound outside Engine.swap_weights")
def _check_serving_params_rebinding(ctx: FileContext):
    """``<obj>.params = ...`` (or ``+=``) in ``serving/`` outside
    ``Engine.__init__``/``Engine.swap_weights`` and
    ``WeightStore.__init__`` installs weights without the swap path's
    gates (shape/dtype checks, provenance, the copy into the engine's
    own tensors)."""
    if not ctx.in_scope(DTT011_SCOPED):
        return
    allowed = DTT011_ALLOWED.get(ctx.rel, set())
    for node in ast.walk(ctx.tree):
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        else:
            continue
        for tgt in targets:
            if not (isinstance(tgt, ast.Attribute)
                    and tgt.attr == "params"):
                continue
            fn = ctx.enclosing_fn(node)
            if fn is not None and fn.name in allowed:
                continue
            where = f"`{fn.name}`" if fn is not None else "module scope"
            yield (node.lineno,
                   f"`.params` rebound in {where} — weights change "
                   "ONLY through Engine.swap_weights; a bare rebinding "
                   "skips every swap gate")
