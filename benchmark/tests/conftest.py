"""The tiny sizes of configurations that came after ``_tiny.py``, joined to
its table here, so that the tests parametrized over every cell run them
too."""
import _tiny

# above 50,000 observations, so the planner keeps the int8 pair; fewer
# compounds than features and F >= 4,096, so it picks the dual solve
_tiny.SIZES.setdefault("chembl", dict(n_compounds=2_000, n_targets=100,
                                      n_features=4_096, nnz=60_000,
                                      n_test=2_000, feat_per_compound=20))
