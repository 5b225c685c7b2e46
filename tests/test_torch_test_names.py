"""Each port test module defines every top-level name once.

A second ``def test_x`` in a module replaces the first, and pytest then
never collects the first test: it neither runs nor fails. This parses every
``tests/test_torch_*.py`` with ``ast`` and fails on any top-level function,
class or assigned name defined twice in one module.
"""
import ast
from pathlib import Path


def _defined(tree):
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            yield node.name, node.lineno
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [
                node.target]
            for t in targets:
                for leaf in ast.walk(t):
                    if isinstance(leaf, ast.Name):
                        yield leaf.id, node.lineno


def test_no_port_test_module_defines_a_name_twice():
    files = sorted(Path(__file__).parent.glob("test_torch_*.py"))
    assert len(files) > 10, files
    twice = []
    for path in files:
        seen = {}
        for name, line in _defined(ast.parse(path.read_text())):
            if name in seen:
                twice.append(f"{path.name}: {name} at lines {seen[name]} "
                             f"and {line}")
            seen.setdefault(name, line)
    assert not twice, "defined twice: " + "; ".join(twice)
