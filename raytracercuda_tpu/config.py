"""Runtime configuration for the ray-tracing framework.

This replaces the reference's compile-time flag layer (`Raytracer/Types.h:8-13`:
``#define CUDA 0/1`` and ``TREE_TYPE TREE|HASH|PROGRESSIVE``) and the kernel
tuning ``#define`` knobs (`Raytracer/BuildTree.cuh:10-21`, `Raytracer/Hash.cu:4-11`,
`Raytracer/Trace2.cu:3-9`) with real runtime dataclasses.  Backend selection is
a value, not a build flag; every knob the reference hardcodes is a field here.
"""

from __future__ import annotations

import dataclasses
import enum


class AccelKind(enum.Enum):
    """Acceleration-structure selector.

    Mirrors the reference's ``TREE_TYPE`` compile-time selector
    (`Raytracer/Types.h:10-13`):

    - ``BVH``:     LBVH over flattened, stackless (skip-link) node arrays —
                   the deterministic replacement for the atomic kd-tree
                   (`Raytracer/BuildTree.cu`).
    - ``GRID``:    Fletcher16 hashed uniform grid, CSR face lists — the
                   deterministic replacement for the spatial hash
                   (`Raytracer/Hash.cu`).
    - ``WAVEFRONT``: queue/compaction-based traversal over the same BVH —
                   completes the reference's unfinished "PROGRESSIVE" path
                   (`Raytracer/Trace2.cu`).
    - ``CLUSTER``: Morton-ordered flat triangle clusters culled DENSELY
                   (matrix form) against pixel-tile beams — the product
                   path; see `accel/clusters.py` and `trace/dense.py`.
    - ``BRUTE``:   no structure; tiled all-pairs intersection.  This is the
                   correctness oracle, the analog of the reference's
                   ``#define CUDA 0`` CPU fallback (`Raytracer/CudaComon.cuh:36-56`).
    """

    BVH = "bvh"
    GRID = "grid"
    WAVEFRONT = "wavefront"
    CLUSTER = "cluster"
    BRUTE = "brute"


@dataclasses.dataclass(frozen=True)
class BvhConfig:
    """LBVH build/traversal knobs (replaces `Raytracer/BuildTree.cuh:10-21`)."""

    #: Morton quantization bits per axis (30-bit codes).
    morton_bits: int = 10
    #: Upper bound on tree depth used for bounded refit/skip-link propagation
    #: passes (analog of BUILD_TREE_MAX_DEPTH=38, `BuildTree.cuh:15`).
    max_depth: int = 64
    #: Max traversal iterations per ray (safety bound; analog of the
    #: reference's bounded stacks + MAX_SEARCH_ITERS=400, `Hash.cu:11`).
    max_iters: int = 4096
    #: Collapse subtrees with <= this many faces into a single leaf
    #: (analog of MAX_FACES_PER_BOX=256, `BuildTree.cuh:17`).  Larger
    #: leaves make a shallower tree — shorter beam walks and bigger dense
    #: leaf sweeps.
    max_leaf_faces: int = 16


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """Dense cluster structure knobs (`accel/clusters.py`).

    Plays the role of the reference's leaf-capacity knobs
    (MAX_FACES_PER_BOX, `BuildTree.cuh:17`) for the dense fast path.
    """

    #: Morton-consecutive triangles per cluster.  The dense sweep tests
    #: whole clusters, so this is the work granularity: smaller = tighter
    #: culling, larger = fewer/cheaper bookkeeping rows.
    cluster_size: int = 128
    #: Morton quantization bits per axis.
    morton_bits: int = 10


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Hashed uniform-grid knobs (replaces `Raytracer/Hash.cu:4-11`)."""

    #: Cell edge length (CELL_RES=0.03, `Hash.cu:8`).
    cell_res: float = 0.03
    #: Number of hash cells (MAX_HASH_ELEMENTS=65536, `BuildTree.cuh:20`).
    num_cells: int = 65536
    #: Push-through epsilon when DDA-advancing through a cell
    #: (CELL_PINCH_TROUGH_EPSILON, `Hash.cu:10`).
    pinch_epsilon_frac: float = 0.001
    #: Max DDA iterations per ray (MAX_SEARCH_ITERS=400, `Hash.cu:11`).
    max_search_iters: int = 400
    #: Max cells a single triangle may overlap during build (bounds the
    #: rasterization loop; reference loops AABB cells unbounded).
    max_cells_per_face: int = 64
    #: Max faces tested per cell visit (NUM_FACES_PER_CELL=256, `Hash.cu:7`).
    max_faces_per_cell: int = 256


@dataclasses.dataclass(frozen=True)
class WavefrontConfig:
    """Wavefront/queue traversal knobs (replaces `Raytracer/Trace2.cu:3-9`)."""

    #: Hits kept per ray before reduction (MAX_HITS_PER_RAY_BLOCK=16,
    #: `Trace2.cu:3`).
    max_hits_per_ray: int = 16
    #: Rounds of queue expansion before compaction.
    rounds_per_compaction: int = 8
    #: Rays per sequential block — bounds stage B's [rays, Q*K, 3]
    #: intermediates.
    ray_chunk: int = 4096


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Per-trace options."""

    #: Clip hits behind the origin (t < eps).  The reference's
    #: `bmTriIntersect` (`CudaComon.cuh:117-155`) performs NO positivity
    #: check; set False for bit-parity experiments with that behavior.
    clip_backward_hits: bool = True
    #: Epsilon for t>eps clipping and shadow-ray offsets.
    t_epsilon: float = 1e-4
    #: Ray-tile size for kernels (flattened pixels per tile; the analog of
    #: MARCH_THREADS=256 blocks, `BuildTree.cuh:13`).
    tile_rays: int = 8192
    #: Triangle-chunk size for brute-force intersection sweeps.
    tile_faces: int = 256
    #: Ray-tile size for the brute-force (all-pairs) tracer; bounds the
    #: [rays x faces] intermediate to tile_rays_brute * tile_faces lanes.
    tile_rays_brute: int = 2048
    #: Use beam (tile-frustum) traversal for pinhole frames (common origin,
    #: known width/height).  Falls back to per-ray traversal otherwise.
    use_beam: bool = True
    #: Pixels per beam-tile edge (16 -> 256 rays share one traversal).
    beam_tile: int = 16
    #: Candidate-leaf queue length per beam round.
    beam_queue: int = 128
    #: Beam tiles processed together in the dense test phase (bounds the
    #: [tiles x rays x candidates] intermediate).
    beam_tiles_per_chunk: int = 32
    #: --- dense (CLUSTER) fast-path knobs (`trace/dense.py`) -------------
    #: Pixels per dense-tile edge.
    dense_tile_px: int = 16
    #: Candidate clusters tested per tile per round (the K window).
    dense_round_clusters: int = 32
    #: Tiles processed together in the dense sweep (bounds the
    #: [tiles x rays x K*cluster_size] intermediate).
    dense_tiles_per_chunk: int = 32
    #: Cluster-column chunk for the [tiles x clusters] cull/sort rectangle;
    #: scenes with more clusters run multiple exact passes.
    dense_cluster_chunk: int = 8192


@dataclasses.dataclass(frozen=True)
class DiffConfig:
    """Differentiable-rendering estimator knobs (`diff/`).

    The default stop-grad/recompute VJPs are exact for interior pixels
    only; ``silhouette=True`` adds the edge-sampling boundary term
    (`diff/edge_grad.py`) so gradients also capture coverage changes at
    silhouettes — the derivative of the box-filtered image."""

    #: Include the silhouette boundary term in backward passes routed
    #: through `render_rgb_silhouette`.
    silhouette: bool = True
    #: Deterministic stratified samples per silhouette edge.
    edge_samples: int = 4
    #: Radiance-probe offset from the edge, as a fraction of pixel size.
    edge_offset_px: float = 0.05


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Top-level framework configuration (replaces `Types.h` + knob defines)."""

    accel: AccelKind = AccelKind.BVH
    bvh: BvhConfig = dataclasses.field(default_factory=BvhConfig)
    cluster: ClusterConfig = dataclasses.field(default_factory=ClusterConfig)
    grid: GridConfig = dataclasses.field(default_factory=GridConfig)
    wavefront: WavefrontConfig = dataclasses.field(default_factory=WavefrontConfig)
    trace: TraceConfig = dataclasses.field(default_factory=TraceConfig)
    diff: DiffConfig = dataclasses.field(default_factory=DiffConfig)


DEFAULT_CONFIG = RenderConfig()
