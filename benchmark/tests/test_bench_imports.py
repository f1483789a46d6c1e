"""Nothing under benchmark/ imports JAX, flax or the JAX package, and the
reference imports nothing of the port. Module names are compared by their
top-level part whole: the port's name begins with the JAX package's."""

import ast
import os
import sys

from harness import common
from tiny import ROOT

BENCH = os.path.join(ROOT, 'benchmark')
FORBIDDEN = {'jax', 'jaxlib', 'flax', 'fitv2_tpu'}


def imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split('.')[0]


def sources(folder):
    for dirpath, _, files in os.walk(folder):
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(dirpath, f)


def test_no_jax_anywhere():
    for path in sources(BENCH):
        assert not set(imports(path)) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_port():
    for path in sources(os.path.join(BENCH, 'reference')):
        assert 'fitv2_tpu_torch' not in set(imports(path)), path


def test_top_level_names_are_compared_whole():
    assert 'fitv2_tpu_torch' not in FORBIDDEN
    saved = dict(sys.modules)
    try:
        sys.modules['fitv2_tpu_torch_fake'] = object()
        assert 'fitv2_tpu' not in common.forbidden_loaded()
        sys.modules['fitv2_tpu.fake'] = object()
        assert 'fitv2_tpu' in common.forbidden_loaded()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
