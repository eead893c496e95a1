"""Sharded execution over ``torch.distributed``: one process per rank.

The counterpart of the JAX package's ``parallel/``: ``mesh`` (dp and tp
axes over the group's ranks), ``sharding`` (dp-sharded evaluation,
tp-sharded RBF CG), ``ring`` (the sp-sharded compact-RBF ring),
``cholesky`` (the tp-sharded blocked Cholesky), ``dryrun`` (every path
once), and ``launch`` (joining a group, starting ranks), which JAX does
not need.  As in the JAX package, importing this subpackage imports
``mesh`` and ``sharding``; none of it starts a group or touches a card
until called.
"""

from . import mesh, sharding  # noqa: F401
