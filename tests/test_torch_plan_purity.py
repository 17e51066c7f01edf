"""The port's plan phase is pure numpy: no function reachable from a plan
hook loads the name ``torch``.

The torch-aware counterpart of fedlint's FHL002, which looks only for
jax/jnp. It reuses ``tools.fedlint.rules``' reachability (the plan entry
hooks, ``_FuncInfo``'s name-matched call edges and the breadth-first
walk of ``plan_phase_findings``) over ``src/repro_torch``, and leaves
fedlint's files and rule IDs as they are.
"""
import ast
import pathlib

from tools.fedlint.rules import PLAN_ENTRY_NAMES, _FuncInfo

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def _annotation_ids(fn: ast.AST) -> set[int]:
    """Node ids inside the annotations of ``fn`` and its nested defs
    (``-> torch.Tensor`` is not a use)."""
    out = set()
    for node in ast.walk(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            args = node.args.posonlyargs + node.args.args + \
                node.args.kwonlyargs
            for sub in [node.returns] + [a.annotation for a in args]:
                if sub is not None:
                    out.update(id(n) for n in ast.walk(sub))
    return out


def torch_in_plan_phase(universe: dict[str, ast.Module]) -> list[str]:
    """``path:line function (from hook)`` for every load of ``torch`` in
    a function reachable from a plan hook, walking the call graph as
    fedlint does."""
    by_name: dict[str, list[_FuncInfo]] = {}
    infos = []
    for path, tree in universe.items():
        for node in ast.walk(tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fi = _FuncInfo(path, node)
                infos.append(fi)
                by_name.setdefault(node.name, []).append(fi)
    entry_of: dict[int, str] = {}
    work = []
    for name in PLAN_ENTRY_NAMES:
        for fi in by_name.get(name, ()):
            if id(fi) not in entry_of:
                entry_of[id(fi)] = name
                work.append(fi)
    while work:
        fi = work.pop()
        for callee in fi.calls:
            if callee in PLAN_ENTRY_NAMES:
                continue
            for target in by_name.get(callee, ()):
                if id(target) not in entry_of:
                    entry_of[id(target)] = entry_of[id(fi)]
                    work.append(target)
    found = []
    for fi in infos:
        if id(fi) not in entry_of:
            continue
        anns = _annotation_ids(fi.node)
        for node in ast.walk(fi.node):
            if isinstance(node, ast.Name) and node.id == "torch" \
                    and isinstance(node.ctx, ast.Load) \
                    and id(node) not in anns:
                found.append(f"{fi.path}:{node.lineno} {fi.node.name} "
                             f"(from {entry_of[id(fi)]})")
    return found


def _universe(root: pathlib.Path) -> dict[str, ast.Module]:
    return {str(p.relative_to(ROOT)): ast.parse(p.read_text())
            for p in sorted(root.rglob("*.py"))}


def test_port_plan_phase_loads_no_torch():
    universe = _universe(PORT)
    assert len(universe) > 50
    assert torch_in_plan_phase(universe) == []


def test_reaches_the_plan_hooks_of_the_port():
    """The walk starts from the port's own strategy hooks (a rename would
    make the check vacuous)."""
    names = {node.name for tree in _universe(PORT).values()
             for node in ast.walk(tree)
             if isinstance(node, ast.FunctionDef)}
    assert {"plan_round", "plan_events", "plan_fold", "schedule_cycle",
            "_plan_tick"} <= names


PLANTED = '''
import numpy as np
import torch


def helper(x):
    return torch.as_tensor(x).sum()


def numpy_only(x):
    return np.sum(x)


class Bad:
    def plan_round(self, eng, t) -> "torch.Tensor":
        return helper(numpy_only([t]))

    def run_fused(self, eng, s):
        return torch.zeros(3)
'''


def test_planted_torch_in_a_plan_hook_is_flagged():
    """A plan hook that reaches torch through a helper is flagged at the
    helper's line; the execute phase's torch is not."""
    found = torch_in_plan_phase({"planted.py": ast.parse(PLANTED)})
    assert found == ["planted.py:7 helper (from plan_round)"]
