"""The port's chain lint and its build-time hook, against ``repro``'s.

* ``repro_torch.analysis.lint_chain`` gives ``repro.analysis.chain_lint``'s
  findings — code, severity, location and message — on a set of chains:
  an unsatisfiable conjunction ``(GT 5.0, LT 3.0)`` on one column, an
  unsatisfiable OR-group, an unsatisfiable single predicate, AND- and
  OR-level redundancy, an always-true predicate under a declared domain,
  a Bloom key collision, a HASHMIX-shadowed group and the clean paper
  chains.
* ``build_session`` raises on the three unsatisfiable chains in both
  packages, warns once per (code, location) on redundancy, and builds
  the paper chains.
"""

import warnings

import pytest

torch = pytest.importorskip("torch")

import repro.core as R  # noqa: E402
from repro.analysis import chain_lint as R_lint  # noqa: E402
from repro.configs import paper_filters as R_paper  # noqa: E402

import repro_torch.core as T  # noqa: E402
from repro_torch.analysis import diagnostics as T_diag  # noqa: E402
from repro_torch.analysis import lint_chain  # noqa: E402
from repro_torch.configs import paper_filters as T_paper  # noqa: E402
from repro_torch.core import session as T_session  # noqa: E402

GT, LT, BETWEEN, EQ, MIX = (T.OP_GT, T.OP_LT, T.OP_BETWEEN, T.OP_EQ,
                            T.OP_HASHMIX)
assert (GT, LT, BETWEEN, EQ, MIX) == (R.OP_GT, R.OP_LT, R.OP_BETWEEN,
                                      R.OP_EQ, R.OP_HASHMIX)

#: label → (predicate fields, domains); fields as (name, column, op, t1,
#: t2, rounds, group)
CHAINS = {
    "unsat_conjunction": ([("a", 0, GT, 5.0, 0.0, 0, None),
                           ("b", 0, LT, 3.0, 0.0, 0, None)], None),
    "unsat_group": ([("a", 0, BETWEEN, 5.0, 3.0, 0, "g"),
                     ("b", 1, BETWEEN, 2.0, 2.0, 0, "g"),
                     ("c", 2, GT, 0.0, 0.0, 0, None)], None),
    "unsat_predicate": ([("a", 0, BETWEEN, 5.0, 3.0, 0, None),
                         ("b", 1, GT, 0.0, 0.0, 0, None)], None),
    "redundant": ([("loose", 0, GT, 1.0, 0.0, 0, None),
                   ("tight", 0, GT, 2.0, 0.0, 0, None),
                   ("wide", 1, BETWEEN, 0.0, 10.0, 0, "g"),
                   ("narrow", 1, BETWEEN, 2.0, 3.0, 0, "g")], None),
    "always_true": ([("a", 0, GT, -1.0, 0.0, 0, None),
                     ("b", 1, LT, 3.0, 0.0, 0, None)], {0: (0.0, 5.0)}),
    "bloom_and_mix": ([("k1", 0, EQ, 3.0, 0.0, 0, None),
                       ("k2", 0, EQ, 131.0, 0.0, 0, None),
                       ("m", 1, MIX, 0.5, 0.0, 2, "g"),
                       ("p", 2, GT, 1.0, 0.0, 0, "g")], None),
}


def preds(pkg, fields):
    return [pkg.Predicate(name, col, op, t1, t2, rounds=rounds,
                          group=group)
            for name, col, op, t1, t2, rounds, group in fields]


def findings(diags):
    return [(d.code, d.severity, d.location, d.message) for d in diags]


@pytest.mark.parametrize("label", list(CHAINS) + ["paper_flat",
                                                  "paper_cnf"])
def test_lint_chain_equals_repro(label):
    if label.startswith("paper"):
        shape = label.split("_")[1]
        t_chain, r_chain = T_paper.filter_chain(shape), \
            R_paper.filter_chain(shape)
        domains = None
    else:
        fields, domains = CHAINS[label]
        t_chain, r_chain = preds(T, fields), preds(R, fields)
    got = lint_chain(t_chain, domains)
    want = R_lint.lint_chain(r_chain, domains)
    assert findings(got) == findings(want)
    if not label.startswith("paper"):
        assert got                    # every hand-made chain has a finding
    assert all(isinstance(d, T_diag.Diagnostic) for d in got)


@pytest.mark.parametrize("label", ["unsat_conjunction", "unsat_group",
                                   "unsat_predicate"])
def test_build_session_refuses_an_unsatisfiable_chain(label):
    fields, _ = CHAINS[label]
    code = {"unsat_conjunction": "chain-unsat-conjunction",
            "unsat_group": "chain-unsat-group",
            "unsat_predicate": "chain-unsat-predicate"}[label]
    with pytest.raises(ValueError, match=code):
        R.build_session(R.FilterPlan(preds(R, fields), engine="jnp"))
    with pytest.raises(ValueError, match=code):
        T.build_session(T.FilterPlan(preds(T, fields), engine="torch"),
                        device="cpu")


def test_build_session_warns_once_on_redundancy(monkeypatch):
    monkeypatch.setattr(T_session, "_LINT_WARNED", set())
    fields, _ = CHAINS["redundant"]
    plan = T.FilterPlan(preds(T, fields), engine="torch")
    with pytest.warns(UserWarning, match="chain-subsumed") as rec:
        T.build_session(plan, device="cpu")
    codes = sorted(str(w.message).split("] ")[1].split(" @")[0]
                   for w in rec if "chain lint" in str(w.message))
    assert codes == ["chain-subsumed", "chain-subsumed-member"]
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        T.build_session(plan, device="cpu")   # once per (code, location)


@pytest.mark.parametrize("shape", ["flat", "cnf", "wide"])
def test_paper_chains_build_silently(shape):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        T.build_session(T.FilterPlan(T_paper.filter_chain(shape),
                                     engine="torch"), device="cpu")
