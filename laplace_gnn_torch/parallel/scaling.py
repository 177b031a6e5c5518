"""Projected multi-GPU scaling efficiency from single-GPU measurements.

Counterpart of ``laplace_gnn_tpu/parallel/scaling.py``, with the same
formulas. It converts quantities that can be measured on one card (the
per-aggregation compute time and the partition's halo widths) into a
projected scaling curve with a link-bandwidth cost model: compute splits
with the partition, communication is volume / bandwidth, and a collective
issued before independent local work overlaps with it.

The default bandwidths are the published figures of an H100 SXM node
(NVIDIA H100 80GB HBM3, 700 W): HBM3 at 3.35e12 B/s, NVLink 4 at 4.5e11
B/s per direction between the GPUs of a host, and one 400 Gb/s NIC per GPU
(5e10 B/s) between hosts. They are parameters: pass measured figures for
other parts or links.
"""

from __future__ import annotations

from typing import Sequence

H100_NVLINK_BW = 4.5e11   # bytes/s per direction, NVLink 4 (H100 SXM)
H100_NIC_BW = 5.0e10      # bytes/s, one 400 Gb/s NIC per GPU between hosts
H100_HBM_BW = 3.35e12     # bytes/s, HBM3 of the H100 SXM


def projected_scaling(graph, d_features: int, t_compute_1chip: float,
                      n_chips: Sequence[int] = (2, 4, 8, 16),
                      bytes_per_el: int = 4,
                      ici_bw: float = H100_NVLINK_BW,
                      overlap: bool = True,
                      t_fixed: float = 0.0) -> list[dict]:
    """Project the edges/s scaling efficiency of the halo-partitioned
    aggregation.

    It prices the halo alone, as JAX's does: a body's output stays the
    rank's row block, in the port as in JAX (``parallel.sharded``).

    Per GPU and aggregation at ``n`` GPUs:
      t_comp(n) = t_fixed + (t_compute_1chip - t_fixed) / n
                  (edge work splits across the 'graph' axis; ``t_fixed``
                  models the non-scaling launch/latency floor)
      t_comm(n) = halo_rows(n) * d * bytes / ici_bw
                  with halo_rows from the actual partition
                  (sharded.halo_widths), all_to_all schedule: the widest
                  pair padded across the n-1 remote peers
      t_step(n) = max(t_comp, t_comm)   if overlap (the exchange is issued
                  before the independent local segment-sum)
                  t_comp + t_comm       otherwise
      efficiency(n) = t_compute_1chip / (n * t_step(n))

    ``ici_bw`` is the link between the GPUs of the 'graph' axis (NVLink by
    default). Returns one dict per n: {n, halo_rows, t_comp_us, t_comm_us,
    t_step_us, efficiency, edges_per_s}.
    """
    from .sharded import halo_widths

    n_edges = int(graph.src.shape[0])
    out = []
    for n in n_chips:
        # non-divisible node counts take the same padded blocks a real run
        # uses (pad_to_blocks): halo widths computed on ceil(N/n) blocks
        W = halo_widths(graph, n, allow_pad=True)
        H = int(W.max())
        halo_rows = (n - 1) * max(1, H)
        t_comp = t_fixed + (t_compute_1chip - t_fixed) / n
        t_comm = halo_rows * d_features * bytes_per_el / ici_bw
        t_step = max(t_comp, t_comm) if overlap else t_comp + t_comm
        eff = t_compute_1chip / (n * t_step)
        out.append({
            "n": int(n),
            "halo_rows": int(halo_rows),
            "t_comp_us": t_comp * 1e6,
            "t_comm_us": t_comm * 1e6,
            "t_step_us": t_step * 1e6,
            "efficiency": float(eff),
            "edges_per_s": float(n_edges / t_step),
        })
    return out


def dcn_projection(n_nodes: int, d_features: int, n_dcn: int,
                   t_step_1slice: float, bytes_per_el: int = 4,
                   dcn_bw: float = H100_NIC_BW,
                   n_graph: int = 1) -> dict:
    """Extra cost of striping edges across hosts: one sum of the
    (n_nodes/n_graph, d) partial block per aggregation crosses the
    inter-host link (``dcn_bw``, one NIC per GPU by default). A ring/tree
    all-reduce moves 2*(n_dcn-1)/n_dcn of the payload per host.

    Priced serialized (t_comp + t_psum): the sum is on the output of the
    aggregation being computed and the next layer depends on it, so
    overlapping would need cross-layer (feature-chunk) pipelining, which no
    program here performs."""
    payload = (n_nodes // max(n_graph, 1)) * d_features * bytes_per_el
    t_psum = 2.0 * (n_dcn - 1) / max(n_dcn, 1) * payload / dcn_bw
    t_comp = t_step_1slice / n_dcn
    t_step = t_comp + t_psum
    return {"n_dcn": int(n_dcn), "t_psum_us": t_psum * 1e6,
            "t_step_us": t_step * 1e6,
            "efficiency": float(t_step_1slice / (n_dcn * t_step))}


def ring_dense_projection(n_nodes: int, d_features: int,
                          t_matmul_1chip: float,
                          n_chips: Sequence[int] = (2, 4, 8),
                          bytes_per_el: int = 4,
                          ici_bw: float = H100_NVLINK_BW) -> list[dict]:
    """Price the ring dense aggregation (sharded.make_ring_dense_aggregate)
    against the all-gather formulation (sharded.sharded_aggregate).

    Ring: n per-chunk (B, B) x (B, d) products; each of the n-1 hops (B*d
    payload) overlaps the previous chunk's product, so
      t_ring = max(t_comp/n, (n-1) * t_hop + t_comp/n^2)
    (pipeline bound: all compute, or all hops plus one exposed chunk).
    All-gather: collective then one product, serialized:
      t_ag = (n-1)/n * N*d*bytes / ici_bw + t_comp/n.
    Both leave the output sharded, as JAX's bodies do; the port's bodies
    then gather it, (n-1)/n * N*d*bytes more for either, not priced here.
    """
    out = []
    for n in n_chips:
        B = n_nodes / n
        t_comp_n = t_matmul_1chip / n
        t_hop = B * d_features * bytes_per_el / ici_bw
        t_ring = max(t_comp_n, (n - 1) * t_hop + t_comp_n / n)
        t_ag = (n - 1) / n * n_nodes * d_features * bytes_per_el / ici_bw \
            + t_comp_n
        out.append({"n": int(n),
                    "t_ring_us": t_ring * 1e6, "t_allgather_us": t_ag * 1e6,
                    "ring_speedup": float(t_ag / t_ring),
                    "ring_efficiency": float(t_matmul_1chip / (n * t_ring))})
    return out


def format_table(rows: list[dict]) -> str:
    hdr = (f"{'n':>4} {'halo_rows':>10} {'t_comp':>9} {'t_comm':>9} "
           f"{'t_step':>9} {'eff':>6} {'Medges/s':>9}")
    lines = [hdr]
    for r in rows:
        lines.append(
            f"{r['n']:>4} {r['halo_rows']:>10} {r['t_comp_us']:>8.1f}u "
            f"{r['t_comm_us']:>8.1f}u {r['t_step_us']:>8.1f}u "
            f"{r['efficiency']:>6.2f} {r['edges_per_s'] / 1e6:>9.1f}")
    return "\n".join(lines)
