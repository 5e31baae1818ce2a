"""Hand-written CUDA kernels for Hopper, one family per package.

Each family ``<name>/`` has:

``csrc/*.cu``   the CUDA C++ kernels (``sm_90a``) with a plain C interface,
                built by ``build.py`` with ``nvcc`` at first use and loaded
                with ``ctypes``;
``<name>.py``   the wrappers beside their plain PyTorch versions: a CPU
                tensor runs the plain version, a CUDA tensor launches the
                kernel (and bumps its counter in ``registry.LAUNCHES``);
``ops.py``      the public entry: padding, the kernel's size rule, output
                slicing and overflow accounting;
``ref.py``      the oracle.

``registry.py`` lists one job per kernel configuration (inputs bit for bit
the JAX package's) and holds the launch counters.  ``analysis.cuh``,
included by every source, exports each library's kernel resources and
launch configurations to ``analysis/palkit.py`` and holds the device-side
checks of the checked build (``-DREPRO_KERNEL_CHECKS``).  Families:

``hier_merge``     merge-path two-way / multi-way canonical-segment merge —
                   the paper's layer-merge hot path;
``embedding_bag``  weighted gather-reduce of table rows — DCN-v2's serving
                   lookup;
``segment_agg``    sorted segment sum — GNN message passing.
"""
