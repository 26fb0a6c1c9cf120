"""The benchmark's plain reference of the port's superstep physics.

Written from the physics the configurations state (the upstream DeviceKMC
equations, as ``portbench/configs/*.json`` give their constants), in plain
PyTorch and NumPy. It imports neither ``jax`` nor any package of this
repository: every table it needs (neighbor lists, the K system, rates,
random streams) it works out again from the raw structure (positions,
elements, contact size) and the parameters.

Modules:

* ``lattice``: neighbor lists by cell binning, layer ids.
* ``fields``: site charges, the boundary (K) system and its Jacobi CG,
  the pairwise screened-Coulomb potential.
* ``events``: the rate table and the two event loops (the serial
  residence-time loop on an mt19937 stream, the batched exponential race on
  a threefry key), replayed step for step.
* ``streams``: mt19937 (std::mt19937 + libstdc++ ``uniform_real_distribution``)
  and threefry-2x32 (``jax.random``'s split and uniform).
"""
