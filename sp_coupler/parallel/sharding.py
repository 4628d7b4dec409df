"""Sharding constraints inside the jitted coupled step.

The fused step is written for `jax.jit` over a mesh: sharding is declared
with `with_sharding_constraint` at the phase boundaries (scaling-book
recipe: pick a mesh, annotate, let XLA insert the collectives).

- LES fleet arrays carry P('les', ...) so every instance's substeps run
  where its state lives; slab reductions stay device-local.
- The per-column coupling arrays [n_les, L] are also P('les'): the GCM ->
  LES gather and LES -> GCM scatter become small all-to-all/all-gathers
  inserted by XLA at the spectral/grid boundary.
- GCM spectral state is replicated by default (T21-T255 state is tiny
  compared to one LES instance); a lat-sharded GCM kicks in at TL639 scale.
"""

import jax
from jax.sharding import PartitionSpec as P


def spatial_axes(mesh):
    """Whether the mesh carves the LES horizontal plane (reference P2,
    --lesprocs / DALES nprocx x nprocy)."""
    return mesh is not None and (
        mesh.shape.get("x", 1) > 1 or mesh.shape.get("y", 1) > 1)


def constrain_fleet(state, mesh):
    """Constrain an LES fleet pytree onto the mesh.

    Batch axis -> 'les'. With x/y mesh axes > 1, 3-D+ fields additionally
    shard their horizontal plane as P('les', None, 'y', 'x') (layout
    [n, z(+1), y, x]); XLA/GSPMD then materializes the stencil rolls as
    halo collective-permutes and the slab means as psums — the SPMD
    equivalent of DALES's 2-D domain decomposition + MPI halo exchange.
    """
    if mesh is None:
        return state
    spatial = spatial_axes(mesh)

    def con(x):
        nd = getattr(x, "ndim", 0)
        if nd == 0:
            return x
        if spatial and nd >= 4:
            spec = P("les", None, "y", "x")
        else:
            spec = P("les")
        return jax.lax.with_sharding_constraint(
            x, jax.sharding.NamedSharding(mesh, spec))

    return jax.tree.map(con, state)


def constrain_columns(tree, mesh):
    """Constrain per-column dicts/[n, L] arrays to the les axis."""
    if mesh is None:
        return tree
    nd = jax.sharding.NamedSharding(mesh, P("les"))
    return jax.tree.map(
        lambda x: jax.lax.with_sharding_constraint(x, nd)
        if getattr(x, "ndim", 0) >= 1 else x, tree)


def replicated(tree, mesh):
    if mesh is None:
        return tree
    nd = jax.sharding.NamedSharding(mesh, P())
    return jax.tree.map(
        lambda x: jax.lax.with_sharding_constraint(x, nd), tree)
