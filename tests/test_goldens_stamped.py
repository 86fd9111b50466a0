"""Quick-tier guard: stamped golden artifacts match the current sources.

golden/* artifacts are MEASURED Monte-Carlo results; each one that carries a
``semantics`` stamp must match ``semantics_fingerprint()`` at HEAD,
otherwise the measurement predates a decoder-semantics change and must be
re-measured (``python tools/regen_goldens.py <stage>``) — or, after a
VERIFIED-neutral change (the BLER gates pass against the
existing artifact), re-stamped with ``python tools/regen_goldens.py
--restamp``.  Without this test the stale-stamp guard only trips inside
regen tools, i.e. silently (advisor round-3 finding).
"""
import glob
import json
import os

from ldpc_3gpp_tpu.utils.fingerprint import semantics_fingerprint

GOLDEN = os.path.join(os.path.dirname(__file__), "..", "golden")


def test_stamped_goldens_match_current_fingerprint():
    current = semantics_fingerprint()
    stamped = []
    stale = []
    for path in sorted(glob.glob(os.path.join(GOLDEN, "*.json"))):
        with open(path) as f:
            data = json.load(f)
        if isinstance(data, dict) and "semantics" in data:
            stamped.append(os.path.basename(path))
            if data["semantics"] != current:
                stale.append(
                    f"{os.path.basename(path)}: {data['semantics']} "
                    f"!= {current}"
                )
    assert stamped, "no stamped goldens found — stamping regressed?"
    assert not stale, (
        "stale golden stamps (re-measure with tools/regen_goldens.py, or "
        "re-stamp with --restamp after the on-chip gates verify the change "
        f"was semantics-neutral): {stale}"
    )


def test_fingerprint_ignores_comments_and_docstrings(tmp_path, monkeypatch):
    """The hash is over normalized ASTs: a comment-only edit to a semantics
    file must NOT change the fingerprint (raw-byte hashing did, silently
    invalidating valid artifacts)."""
    import shutil

    import ldpc_3gpp_tpu.utils.fingerprint as fp

    pkg_root = os.path.join(os.path.dirname(fp.__file__), "..")
    clone = tmp_path / "pkgclone"
    for sub in ("ops", "models", "spec", "utils"):
        shutil.copytree(os.path.join(pkg_root, sub), clone / sub)
    monkeypatch.setattr(
        fp.os.path, "dirname", lambda p, _d=os.path.dirname: (
            str(clone / "utils") if p == fp.__file__ else _d(p)
        ),
    )
    before = fp.semantics_fingerprint()
    target = clone / "models" / "chain.py"
    target.write_text("# a new leading comment\n" + target.read_text())
    assert fp.semantics_fingerprint() == before
    # but an executable-structure change DOES change it
    target.write_text(target.read_text() + "\n_SEMANTICS_PROBE = 1\n")
    assert fp.semantics_fingerprint() != before


def test_fingerprint_stable_across_interpreter_field_additions():
    """New Python minors add new (empty-by-default) AST fields — e.g. 3.12's
    ``type_params`` on FunctionDef — which made ast.dump-based stamps
    interpreter-version-dependent (advisor round-4).  The serializer skips
    None/empty-list fields, so a simulated future interpreter that grows an
    extra empty field hashes identically."""
    import ast

    from ldpc_3gpp_tpu.utils.fingerprint import _serialize

    src = "def f(x):\n    return x + 1\n"

    def ser(tree):
        out = []
        _serialize(tree, out)
        return "".join(out)

    base = ser(ast.parse(src))
    grown = ast.parse(src)
    fd = grown.body[0]
    fd._fields = fd._fields + ("future_field",)  # instance shadows class
    fd.future_field = []
    assert ser(grown) == base
    # a POPULATED new field must still change the hash (real semantics)
    fd.future_field = [ast.Constant(value=1)]
    assert ser(grown) != base
