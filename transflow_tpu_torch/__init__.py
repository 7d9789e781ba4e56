"""transflow_tpu_torch: the PyTorch/CUDA port of transflow_tpu.

The JAX package ``transflow_tpu`` is the reference; this package mirrors
its layout and names, runs on PyTorch, and replaces each Pallas TPU kernel
with a CUDA kernel written for Hopper (``csrc/``). It imports no JAX.

Ported so far: Farneback (kernels B1, B2a and B2b for its polynomial
expansion, warp and solve) and LiteFlowNet (with the bounded backwarp
behind ``lfn_warp_bound``), through the flagship step
``model.FlowTransferModel`` and the device ``engine.Engine`` over flow
sources whose ``CvFlowConfig`` selects the estimator, under a
``parallel.SpaceMesh`` too (the sharded correlation),
with JAX's own random numbers (``prng``); the flow post-processing
(filters, masks, kernels, ``-d forward`` through kernel B5), the merges
and every layer class with its masks; and the disk-to-disk
``pipeline.Pipeline`` behind the JAX package's command line
(``python -m transflow_tpu_torch``, ``cli.py``), over image sequences and
``.flow.zip`` archives, writing frames, flow archives and checkpoints;
``--mv`` and ``-o x.mp4`` through the repo's prebuilt libav shim
(``av_native``); and the ``stream`` mesh axis (``parallel.make_mesh``,
``sharded_scan``) behind ``tools/batch_render.py``. ROADMAP.md lists
what comes next.
"""

__version__ = "0.1.0"
