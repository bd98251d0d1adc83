"""No run loads JAX or the JAX package, and the reference imports nothing
of the program."""

import ast
import glob
import os
import subprocess
import sys
import textwrap

from conftest import ROOT

FORBIDDEN = {'jax', 'jaxlib', 'flax', 'vfs_tpu'}


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(ROOT, 'portbench', 'reference',
                                       '*.py')):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for name in names:
                top = name.split('.')[0]
                assert top not in FORBIDDEN | {'vfs_tpu_torch', 'portbench'}, \
                    (path, name)


def test_rehearsal_loads_no_jax(tmp_path):
    """Each tiny cell's set-up, window and check in a fresh process, then
    its modules' top-level names, compared whole."""
    script = textwrap.dedent(f'''
        import sys
        sys.path.insert(0, {ROOT!r})
        sys.path.insert(0, {os.path.join(ROOT, 'portbench', 'tests')!r})
        from conftest import make_tiny_copy, TINY
        from helpers import run_cell
        bench_dir = make_tiny_copy({str(tmp_path)!r})
        for cell, *_ in TINY:
            rc, line = run_cell(bench_dir, cell, trace=1)
            assert rc == 0 and line['correct'], line
        tops = sorted({{m.split('.')[0] for m in sys.modules}})
        print(' '.join(tops))
    ''')
    out = subprocess.run([sys.executable, '-c', script], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(out.stdout.split())
    assert 'vfs_tpu_torch' in tops and 'torch' in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN
