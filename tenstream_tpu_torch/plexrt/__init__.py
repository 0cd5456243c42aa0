"""plexrt: TenStream radiative transfer on extruded triangle meshes (port
of `tenstream_tpu/plexrt/`; reference `plexrt/plex_grid.F90`,
`plexrt/plex_rt.F90`).

A structured triangulation (`mesh`: each rectangle split along its
diagonal, the second triangle the first rotated by 180 degrees) or an
unstructured ICON mesh (`icon`), extruded over nz layers; one canonical
wedge table (`optprop`) serves every cell.  Solvers: `solver.PlexrtSolver`
(structured, 5_8 and 18_8) and `solver_unstructured.PlexrtSolverIcon`;
thermal 3-D correction: `nca`.
"""
