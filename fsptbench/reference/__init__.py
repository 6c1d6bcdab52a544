"""The plain reference the benchmark holds the program to: plain PyTorch
and NumPy that import nothing of the program.  scene.py compiles the raw
scene inputs, bvh.py casts rays through a tree of its own, rng.py and
shading.py state the estimator's streams and per-lane formulas, render.py
traces a whole step lane by lane (and differentiably, for a train step),
tonemap.py makes the viewer's display frame."""
