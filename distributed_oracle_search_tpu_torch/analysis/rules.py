"""The ``dos-lint`` project-contract rules.

Each rule encodes one convention of the JAX package that every change
must preserve (the README's "Static analysis" table lists them); the
port's copy holds the port to the same conventions:

=================  =====================================================
``env-discipline``  every ``DOS_*`` env read goes through ``utils.env``
                    (the degrade-don't-crash knob policy)
``atomic-writes``   durable artifacts go through ``utils.atomicio``
                    (the tmp+fsync+rename discipline)
``metric-registry`` metric names live in the ``obs/__init__`` metric
                    map and follow ``_total``/``_seconds`` naming
                    (the observability contract)
``silent-except``   a broad ``except`` must re-raise, log, or book a
                    metric (degradation must be observable)
``wire-compat``     codecs tolerate unknown keys and reject only NEWER
                    schema versions (the ``validate_manifest`` gate)
``jit-purity``      no Python side effects inside jit/shard_map/pallas
                    functions (trace-time effects fire once, not per
                    call — the silent-wrong-metrics class of bug)
``lock-scope``      no blocking call while holding a lock (the static
                    half of ``utils.locks``' runtime detector)
``fifo-hygiene``    FIFO opens carry the bounded-deadline pattern
                    (``O_NONBLOCK``/``O_RDWR`` — a blocking open on a
                    dead peer's FIFO wedges forever)
=================  =====================================================

Rules are AST-level and intentionally heuristic where real dataflow
would be needed (``atomic-writes`` tracks string fragments through
simple same-function assignments, nothing more). False positives are
handled by the suppression grammar — WITH a justification, which is the
point: the exemption is then in the diff, not in anyone's head.
"""

from __future__ import annotations

import ast
import re

from .core import FileContext, Finding

#: argument name → rule instance registry
ALL_RULES: list = []


def _register(cls):
    ALL_RULES.append(cls())
    return cls


def rule_by_name(name: str):
    for r in ALL_RULES:
        if r.name == name:
            return r
    raise KeyError(name)


# -------------------------------------------------------------- helpers

def dotted(node: ast.AST) -> str:
    """``a.b.c`` for nested Name/Attribute chains, "" otherwise."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def const_str(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def string_fragments(node: ast.AST) -> list[str]:
    """Every string literal under ``node`` (f-strings, concats,
    os.path.join args — the lint-grade substitute for dataflow)."""
    out: list[str] = []
    for n in ast.walk(node):
        s = const_str(n)
        if s is not None:
            out.append(s)
    return out


def walk_shallow(body):
    """Walk statements without descending into nested function/class
    definitions (their bodies run in another frame/time; each function
    gets its own scope pass, so descending here would double-report)."""
    stack = list(body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


class Rule:
    name = ""
    description = ""

    def check(self, ctx: FileContext):
        raise NotImplementedError

    def finding(self, node: ast.AST, message: str) -> Finding:
        return Finding(self.name, "", getattr(node, "lineno", 0),
                       getattr(node, "col_offset", 0) + 1, message)


# -------------------------------------------------------- env-discipline

@_register
class EnvDiscipline(Rule):
    name = "env-discipline"
    description = ("DOS_* env keys are read through utils.env "
                   "(env_cast/env_str/env_flag), nowhere else")

    ALLOWED = ("utils/env.py",)

    def _is_dos_key(self, node) -> bool:
        s = const_str(node)
        return s is not None and s.startswith("DOS_")

    def check(self, ctx: FileContext):
        if ctx.relpath.endswith(self.ALLOWED):
            return
        for node in ast.walk(ctx.tree):
            key = None
            if isinstance(node, ast.Call):
                fn = dotted(node.func)
                if fn in ("os.environ.get", "os.getenv",
                          "os.environ.pop", "os.environ.setdefault") \
                        and node.args \
                        and self._is_dos_key(node.args[0]):
                    key = const_str(node.args[0])
            elif isinstance(node, ast.Subscript):
                if dotted(node.value) == "os.environ" \
                        and isinstance(getattr(node, "ctx", None),
                                       ast.Load) \
                        and self._is_dos_key(node.slice):
                    key = const_str(node.slice)
            elif isinstance(node, ast.Compare):
                if len(node.ops) == 1 \
                        and isinstance(node.ops[0], (ast.In, ast.NotIn)) \
                        and dotted(node.comparators[0]) == "os.environ" \
                        and self._is_dos_key(node.left):
                    key = const_str(node.left)
            if key is not None:
                yield self.finding(
                    node,
                    f"direct os.environ read of {key!r} bypasses "
                    f"utils.env (use env_cast/env_str/env_flag: one "
                    f"parse policy, malformed values degrade instead "
                    f"of crashing)")


# --------------------------------------------------------- atomic-writes

#: substrings marking a path as a durable artifact
_DURABLE = (".json", ".npy", ".npz", ".trace", ".csv", ".xy", ".scen",
            ".diff", ".results", ".paths", "ledger", "manifest")

_WRITE_MODES = ("w", "wb", "w+", "wb+", "+w", "x", "xb")


@_register
class AtomicWrites(Rule):
    name = "atomic-writes"
    description = ("open(mode='w'/'wb') targeting a durable artifact "
                   "path must go through utils.atomicio")

    ALLOWED = ("utils/atomicio.py",)

    def _open_mode(self, call: ast.Call) -> str | None:
        if not (isinstance(call.func, ast.Name)
                and call.func.id == "open"):
            return None
        if len(call.args) >= 2:
            return const_str(call.args[1])
        for kw in call.keywords:
            if kw.arg == "mode":
                return const_str(kw.value)
        return None

    def _durable(self, frags) -> str | None:
        for f in frags:
            for pat in _DURABLE:
                if pat in f:
                    return f
        return None

    def check(self, ctx: FileContext):
        if ctx.relpath.endswith(self.ALLOWED):
            return
        # per-function string-fragment propagation: path = join(d,
        # "degraded.json"); open(path, "w") still resolves
        funcs = [n for n in ast.walk(ctx.tree)
                 if isinstance(n, (ast.FunctionDef,
                                   ast.AsyncFunctionDef))]
        scopes = [(ctx.tree, None)] + [(f, f.name) for f in funcs]
        for scope, fname in scopes:
            body = scope.body if hasattr(scope, "body") else []
            # pass 1: collect every assignment's string fragments (the
            # shallow walk is unordered, and `path = ...` may sit after
            # the open() in traversal order)
            assigned: dict[str, list[str]] = {}
            for node in walk_shallow(body):
                if isinstance(node, ast.Assign):
                    frags = string_fragments(node.value)
                    if frags:
                        for tgt in node.targets:
                            if isinstance(tgt, ast.Name):
                                assigned.setdefault(
                                    tgt.id, []).extend(frags)
            # pass 2: the open() calls
            for node in walk_shallow(body):
                if not isinstance(node, ast.Call):
                    continue
                mode = self._open_mode(node)
                if mode not in _WRITE_MODES:
                    continue
                target = node.args[0] if node.args else None
                frags = string_fragments(target) if target is not None \
                    else []
                if isinstance(target, ast.Name):
                    frags = frags + assigned.get(target.id, [])
                hit = self._durable(frags)
                writer_name = fname or ""
                if hit is None and not (
                        writer_name.startswith(("write_", "save",
                                                "dump", "_write"))):
                    continue
                what = (f"path matches durable artifact {hit!r}"
                        if hit is not None else
                        f"writer function {writer_name!r}")
                yield self.finding(
                    node,
                    f"raw open(..., {mode!r}) — {what}; a crash "
                    f"mid-write leaves a torn artifact readers will "
                    f"load as garbage (use utils.atomicio "
                    f"atomic_write_bytes/_json/_npy: tmp+fsync+rename)")


# ------------------------------------------------------- metric-registry

_METRIC_KINDS = {"counter": "_total", "histogram": "_seconds"}


@_register
class MetricRegistry(Rule):
    name = "metric-registry"
    description = ("metric names appear in the obs/__init__ metric map "
                   "and follow _total/_seconds naming")

    ALLOWED = ("obs/metrics.py",)

    @staticmethod
    def _expand_doc(doc: str) -> str:
        """Expand the map's brace families
        (``serve_cache_{hits,misses,evictions}_total``) into the full
        names so the substring check sees every member."""
        extra = []
        for m in re.finditer(r"(\w+)?\{([\w,]+)\}(\w*)", doc):
            pre, alts, suf = m.group(1) or "", m.group(2), m.group(3)
            extra.extend(f"{pre}{alt}{suf}" for alt in alts.split(","))
        return doc + "\n" + "\n".join(extra)

    def check(self, ctx: FileContext):
        if ctx.relpath.endswith(self.ALLOWED):
            return
        doc = self._expand_doc(ctx.config.metric_doc_text())
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = dotted(node.func)
            kind = fn.rsplit(".", 1)[-1]
            if kind not in ("counter", "gauge", "histogram") \
                    or not node.args:
                continue
            name = const_str(node.args[0])
            prefix = None
            if name is None and isinstance(node.args[0], ast.JoinedStr):
                vals = node.args[0].values
                if vals and isinstance(vals[0], ast.Constant):
                    prefix = str(vals[0].value)
            if name is None and prefix is None:
                continue    # dynamic name: nothing checkable here
            suffix = _METRIC_KINDS.get(kind)
            if name is not None and suffix is not None \
                    and not name.endswith(suffix):
                yield self.finding(
                    node,
                    f"{kind} {name!r} should end {suffix!r} (obs "
                    f"naming contract; exporters and the bench-diff "
                    f"gate key off the unit suffix)")
            if name is not None and kind == "gauge" \
                    and name.endswith(("_total", "_seconds")):
                yield self.finding(
                    node,
                    f"gauge {name!r} wears a counter/histogram unit "
                    f"suffix — scrapes will misread its semantics")
            check = name if name is not None else prefix
            if doc and check and check not in doc:
                yield self.finding(
                    node,
                    f"metric {check!r} is not in the obs/__init__ "
                    f"metric map — undocumented series are invisible "
                    f"to operators (add it to the docstring map)")


# --------------------------------------------------------- silent-except

_LOG_METHODS = ("debug", "info", "warning", "error", "exception",
                "critical", "log")
_BOOK_METHODS = ("inc", "observe", "add", "set")


@_register
class SilentExcept(Rule):
    name = "silent-except"
    description = ("a broad except must re-raise, log, or book a "
                   "metric — degradation stays observable")

    def _is_broad(self, handler: ast.ExceptHandler) -> bool:
        t = handler.type
        if t is None:
            return True
        names = [t] if not isinstance(t, ast.Tuple) else list(t.elts)
        for n in names:
            if dotted(n).rsplit(".", 1)[-1] in ("Exception",
                                                "BaseException"):
                return True
        return False

    def _observable(self, handler: ast.ExceptHandler) -> bool:
        for node in walk_shallow(handler.body):
            if isinstance(node, ast.Raise):
                return True
            if isinstance(node, ast.Call):
                fn = dotted(node.func)
                leaf = fn.rsplit(".", 1)[-1]
                root = fn.split(".", 1)[0]
                if leaf in _LOG_METHODS and (
                        "log" in root.lower() or "logging" in fn):
                    return True
                if leaf in _BOOK_METHODS:
                    return True
                if fn.endswith("print_exc") or leaf == "print":
                    return True
            # error-as-data: the caught exception flows into a return
            # value / queue / field — observable by the caller (the
            # statusz "{'error': ...}" idiom)
            if handler.name and isinstance(node, ast.Name) \
                    and node.id == handler.name:
                return True
        return False

    def check(self, ctx: FileContext):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            if self._is_broad(node) and not self._observable(node):
                yield self.finding(
                    node,
                    "broad except swallows the failure invisibly: "
                    "re-raise, log, or book a counter (PR-2 policy — "
                    "every degradation must be observable)")


# ----------------------------------------------------------- wire-compat

_CODEC_NAMES = ("from_json", "from_dict")


@_register
class WireCompat(Rule):
    name = "wire-compat"
    description = ("codec parsers tolerate unknown keys and reject "
                   "only NEWER schema versions")

    def _codec(self, fn) -> bool:
        return (fn.name in _CODEC_NAMES or fn.name.startswith("parse_")
                or fn.name.endswith("_from_json"))

    def check(self, ctx: FileContext):
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                continue
            if not self._codec(fn):
                continue
            # classify names: raw (straight out of json.loads / the
            # dict param) vs filtered (rebuilt by a comprehension,
            # which is the unknown-key-tolerant idiom)
            raw: set[str] = set()
            filtered: set[str] = set()
            params = [a.arg for a in fn.args.args
                      if a.arg not in ("self", "cls")]
            raw.update(params)
            for node in walk_shallow(fn.body):
                if isinstance(node, ast.Assign):
                    is_filtered = isinstance(node.value, ast.DictComp)
                    is_raw = (isinstance(node.value, ast.Call)
                              and dotted(node.value.func)
                              in ("json.loads", "json.load"))
                    for tgt in node.targets:
                        if not isinstance(tgt, ast.Name):
                            continue
                        if is_filtered:
                            filtered.add(tgt.id)
                            raw.discard(tgt.id)
                        elif is_raw:
                            raw.add(tgt.id)
                        else:
                            raw.discard(tgt.id)
                            filtered.discard(tgt.id)
            for node in walk_shallow(fn.body):
                if isinstance(node, ast.Call):
                    for kw in node.keywords:
                        if kw.arg is not None:
                            continue
                        if isinstance(kw.value, ast.Name) \
                                and kw.value.id in raw \
                                and kw.value.id not in filtered:
                            yield self.finding(
                                node,
                                f"codec {fn.name}() splats the raw "
                                f"decoded dict (**{kw.value.id}) into "
                                f"a constructor: one unknown key from "
                                f"a NEWER peer is a TypeError. Filter "
                                f"to known fields first (the "
                                f"HealthStatus/ClusterConfig idiom)")
                if isinstance(node, ast.Compare) \
                        and len(node.ops) == 1 \
                        and isinstance(node.ops[0], ast.NotEq):
                    sides = [node.left] + node.comparators
                    for side in sides:
                        key = None
                        if isinstance(side, ast.Subscript):
                            key = const_str(side.slice)
                        elif isinstance(side, ast.Call) and \
                                dotted(side.func).endswith(".get") \
                                and side.args:
                            key = const_str(side.args[0])
                        if key and "version" in key.lower():
                            yield self.finding(
                                node,
                                f"codec {fn.name}() gates on "
                                f"{key!r} != — an exact-version gate "
                                f"rejects OLDER data it could read. "
                                f"Reject only NEWER versions (the "
                                f"validate_manifest `>` contract)")
                            break


# ------------------------------------------------------------ jit-purity

_JIT_MARKERS = ("jit", "shard_map", "pallas_call")
_IMPURE_ROOTS = ("time", "os", "random")
_MUTATORS = ("append", "extend", "update", "setdefault", "insert",
             "remove", "clear")


@_register
class JitPurity(Rule):
    name = "jit-purity"
    description = ("no Python side effects (time/os/print/metrics/"
                   "captured-container mutation) inside jit/shard_map/"
                   "pallas functions")

    SCOPE = ("ops/", "models/")

    def _in_scope(self, ctx: FileContext) -> bool:
        if not ctx.in_package():
            return True         # fixture corpora: rule applies
        return any(f"distributed_oracle_search_tpu_torch/{d}" in ctx.relpath
                   for d in self.SCOPE)

    def _jit_decorated(self, fn) -> bool:
        for dec in fn.decorator_list:
            names = [dotted(dec)]
            if isinstance(dec, ast.Call):
                names.append(dotted(dec.func))
                names.extend(dotted(a) for a in dec.args)
                names.extend(dotted(k.value) for k in dec.keywords)
            for n in names:
                leaf = n.rsplit(".", 1)[-1]
                if leaf in _JIT_MARKERS:
                    return True
        return False

    def _wrapped_names(self, tree) -> set[str]:
        """``walk = jax.jit(walk_impl)`` marks ``walk_impl`` jitted."""
        out: set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Call) \
                    and dotted(node.func).rsplit(".", 1)[-1] \
                    in _JIT_MARKERS:
                for a in list(node.args) + [k.value
                                            for k in node.keywords]:
                    if isinstance(a, ast.Name):
                        out.add(a.id)
        return out

    def _locals(self, fn) -> set[str]:
        out = {a.arg for a in fn.args.args + fn.args.kwonlyargs
               + fn.args.posonlyargs}
        if fn.args.vararg:
            out.add(fn.args.vararg.arg)
        if fn.args.kwarg:
            out.add(fn.args.kwarg.arg)
        for node in walk_shallow(fn.body):
            if isinstance(node, (ast.Assign, ast.AugAssign,
                                 ast.AnnAssign)):
                tgts = (node.targets if isinstance(node, ast.Assign)
                        else [node.target])
                for t in tgts:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            out.add(n.id)
            elif isinstance(node, (ast.For, ast.comprehension)):
                for n in ast.walk(node.target):
                    if isinstance(n, ast.Name):
                        out.add(n.id)
            elif isinstance(node, ast.With):
                for item in node.items:
                    if item.optional_vars is not None:
                        for n in ast.walk(item.optional_vars):
                            if isinstance(n, ast.Name):
                                out.add(n.id)
        return out

    def check(self, ctx: FileContext):
        if not self._in_scope(ctx):
            return
        wrapped = self._wrapped_names(ctx.tree)
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef,
                                   ast.AsyncFunctionDef)):
                continue
            if not (self._jit_decorated(fn) or fn.name in wrapped):
                continue
            local = self._locals(fn)
            for node in walk_shallow(fn.body):
                if isinstance(node, ast.Call):
                    fdot = dotted(node.func)
                    root = fdot.split(".", 1)[0]
                    leaf = fdot.rsplit(".", 1)[-1]
                    if root in _IMPURE_ROOTS and "." in fdot:
                        yield self.finding(
                            node,
                            f"{fdot}() inside a jit-compiled function "
                            f"runs at TRACE time (once per compile), "
                            f"not per call — hoist it out")
                    elif fdot == "print":
                        yield self.finding(
                            node,
                            "print() inside jit fires once per "
                            "compile, not per call (use jax.debug."
                            "print for traced values)")
                    elif leaf in ("inc", "observe") or fdot in (
                            "counter", "gauge", "histogram"):
                        yield self.finding(
                            node,
                            f"metric call {fdot}() inside jit books "
                            f"once per COMPILE, not per execution — "
                            f"silently wrong numbers; record outside "
                            f"the kernel")
                    elif isinstance(node.func, ast.Attribute) \
                            and node.func.attr in _MUTATORS \
                            and isinstance(node.func.value, ast.Name) \
                            and node.func.value.id not in local:
                        yield self.finding(
                            node,
                            f"mutating captured container "
                            f"{node.func.value.id!r}."
                            f"{node.func.attr}() inside jit is a "
                            f"trace-time side effect — it records "
                            f"tracers once, not values per call")
                elif isinstance(node, (ast.Assign, ast.AugAssign)):
                    tgts = (node.targets
                            if isinstance(node, ast.Assign)
                            else [node.target])
                    for t in tgts:
                        if isinstance(t, ast.Subscript) \
                                and isinstance(t.value, ast.Name) \
                                and t.value.id not in local:
                            yield self.finding(
                                node,
                                f"subscript-assign to captured "
                                f"{t.value.id!r} inside jit mutates "
                                f"at trace time (stores a tracer, "
                                f"fires once) — return values or use "
                                f".at[].set on arrays")


# ------------------------------------------------------------ lock-scope

_LOCKISH = ("lock", "cond", "mutex", "_mu")
_BLOCKING_LEAF = ("sleep",)
_BLOCKING_DOTTED_PREFIX = ("subprocess.", "socket.", "urllib.",
                           "requests.", "http.")
_BLOCKING_EXACT = ("os.open", "open", "send_with_retry", "probe",
                   "urlopen")


@_register
class LockScope(Rule):
    name = "lock-scope"
    description = ("no blocking call (sleep/open/subprocess/socket/"
                   "wire send) while holding a lock")

    def _lockish(self, expr) -> str | None:
        node = expr
        if isinstance(node, ast.Call):
            node = node.func
        name = dotted(node)
        leaf = name.rsplit(".", 1)[-1].lower()
        for pat in _LOCKISH:
            if pat in leaf:
                return name
        return None

    def _blocking(self, call: ast.Call, lock_expr: str) -> str | None:
        fn = dotted(call.func)
        if not fn:
            return None
        leaf = fn.rsplit(".", 1)[-1]
        if leaf in _BLOCKING_LEAF:
            return fn
        if fn in _BLOCKING_EXACT or leaf in ("send_with_retry",):
            return fn
        for pre in _BLOCKING_DOTTED_PREFIX:
            if fn.startswith(pre):
                return fn
        # cond.wait on a DIFFERENT object than the with-context blocks
        # while holding this lock; on the same object it releases it
        if leaf == "wait" and fn != lock_expr + ".wait":
            return fn
        return None

    def check(self, ctx: FileContext):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.With):
                continue
            lock_names = [self._lockish(item.context_expr)
                          for item in node.items]
            lock_names = [n for n in lock_names if n]
            if not lock_names:
                continue
            for inner in walk_shallow(node.body):
                if not isinstance(inner, ast.Call):
                    continue
                hit = self._blocking(inner, lock_names[0])
                if hit:
                    yield self.finding(
                        inner,
                        f"blocking call {hit}() while holding "
                        f"{lock_names[0]!r}: every other thread "
                        f"needing this lock now waits on I/O it "
                        f"cannot see (PR-5 deadlock class; move the "
                        f"call outside the critical section)")


# ---------------------------------------------------------- fifo-hygiene

@_register
class FifoHygiene(Rule):
    name = "fifo-hygiene"
    description = ("FIFO opens use the bounded non-blocking pattern "
                   "(os.open + O_NONBLOCK/O_RDWR + deadline); bare "
                   "socket recv/sendall live only in transport/frames "
                   "readers/writers")

    #: the socket half's one sanctioned home: FrameReader/FrameWriter
    #: own every recv/sendall so torn frames surface as typed,
    #: retryable TransportErrors instead of ad-hoc partial reads
    SOCKET_ALLOWED = ("transport/frames.py",)
    _SOCKET_CALLS = ("recv", "recv_into", "sendall")

    def _mentions_fifo(self, node) -> bool:
        for n in ast.walk(node):
            txt = None
            if isinstance(n, ast.Name):
                txt = n.id
            elif isinstance(n, ast.Attribute):
                txt = n.attr
            else:
                txt = const_str(n)
            if txt and "fifo" in txt.lower():
                return True
        return False

    def check(self, ctx: FileContext):
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = dotted(node.func)
            if fn == "open" and node.args \
                    and self._mentions_fifo(node.args[0]):
                yield self.finding(
                    node,
                    "blocking builtin open() on a FIFO wedges forever "
                    "when the peer is dead (no reader/writer ever "
                    "arrives): use os.open with O_NONBLOCK and a "
                    "bounded deadline loop (worker.server._reply "
                    "pattern)")
            elif fn == "os.open" and node.args \
                    and self._mentions_fifo(node.args[0]):
                flags = " ".join(
                    dotted(n) for n in ast.walk(node)
                    if isinstance(n, (ast.Attribute, ast.Name)))
                if "O_NONBLOCK" not in flags and "O_RDWR" not in flags:
                    yield self.finding(
                        node,
                        "os.open of a FIFO without O_NONBLOCK (or the "
                        "self-reader O_RDWR pattern) blocks until a "
                        "peer appears — a crashed peer wedges this "
                        "process forever (bound it: O_NONBLOCK + "
                        "deadline retry)")
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in self._SOCKET_CALLS \
                    and not ctx.relpath.endswith(self.SOCKET_ALLOWED):
                # the socket half of the rule: wire reads/writes go
                # through the frame codec's readers/writers, nowhere
                # else — a bare recv can return a partial frame that
                # desyncs the stream, and a bare sendall outside the
                # writer lock can interleave mid-frame
                yield self.finding(
                    node,
                    f"bare socket .{node.func.attr}() outside "
                    f"transport/frames.py: partial reads/interleaved "
                    f"writes tear the frame stream — go through "
                    f"FrameReader/FrameWriter (typed retryable "
                    f"TransportError on every failure mode)")
