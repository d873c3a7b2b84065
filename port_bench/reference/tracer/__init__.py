"""A frozen copy of the port's plain renderer, as of commit 8039d02: the
scene model and compiler (scene/), the SDF, camera, RNG and box operations
(ops/), the baked geometry, the map closures and the oracle's march,
normal, shading and bounce loop (render/).

The benchmark's correctness check and its work count run on this copy, so
a later change to the program cannot move the yardstick.  Changes from the
original: ``ops/rng.py:gen_rng`` takes a per-lane frame counter, and
``render/reference.py`` rounds its march and shading state through
``precision.quantize`` (the identity unless the control lowers it)."""
