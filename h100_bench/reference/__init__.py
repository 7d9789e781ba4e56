"""The benchmark's plain reference: what each cell's timed path should
produce, written in plain PyTorch and numpy.

It imports neither JAX nor any package of the program under test, and it
takes nothing the program made: the harness hands it the frames, the
pixmap and the network's weights that it made from the seed, and it works
out every flow, state and frame again. Where it follows the program from a
state the program reached in the measured window, that state is read
through the checkpoint arrays (``Engine.state_arrays``) and judged against
the reference's own start elsewhere (``h100_bench/check.py``).

Modules are found by name: ``<method>.py`` for a flow estimator (the
``method`` of the configuration's ``cv_config``) and ``layer_<class>.py``
for a compositor layer class.
"""
