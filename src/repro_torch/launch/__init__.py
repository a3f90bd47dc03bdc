"""Launch tooling: the production meshes (:mod:`.mesh`), the dry run of
every (architecture × shape) cell on them (:mod:`.dryrun`), the roofline
over its records (:mod:`.roofline`) and the variants of one cell
(:mod:`.perf`). All four run on the host: ``meta`` tensors and a fake
process group, no card."""
