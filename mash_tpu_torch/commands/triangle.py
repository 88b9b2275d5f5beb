"""``mash triangle`` (reference ``CommandTriangle.cpp``).

All-vs-all lower-triangle distances.  The pair space is tiled through the
same device intersection kernels as ``dist``; output is relaxed PHYLIP or
an edge list.  Under a multi-process launch each process computes and
prints only the streamed row stripes it owns (the outputs concatenate in
stripe order); rank 0 alone prints the PHYLIP header, the max p-value and
the unstreamed path.
"""

from __future__ import annotations

import sys

import numpy as np

from mash_tpu_torch.cli.command import Command, Option, split_file
from mash_tpu_torch.cli.setup import sketch_parameter_setup, warn_kmer_size
from mash_tpu_torch.core import stats
from mash_tpu_torch.core.loader import init_from_files
from mash_tpu_torch.io.formatting import cpp_double
from mash_tpu_torch.ops.distance import (
    common_denom_tiled,
    pad_sketches,
    stream_pair_stripes,
)
from mash_tpu_torch.parallel import multihost as mh
from mash_tpu_torch.utils import resolve_device

# Above this many sketches the full [N, N] matrices would not fit in
# host RAM (the 100k north-star needs ~2x40 GB); stripes stream instead.
STREAM_MIN_SKETCHES = 2048


class CommandTriangle(Command):
    name = "triangle"
    summary = "Estimate a lower-triangular distance matrix."
    description = (
        "Estimate the distance of each input sequence to every other "
        "input sequence. Outputs a lower-triangular distance matrix in "
        "relaxed Phylip format. The input sequences can be fasta or "
        "fastq, gzipped or not, or Mash sketch files (.msh) with matching "
        "k-mer sizes. Input files can also be files of file names (see "
        "-l). If more than one input file is provided, whole files are "
        "compared by default (see -i)."
    )
    argument_string = "<seq1> [<seq2>] ..."

    def __init__(self):
        super().__init__()
        self.use_option("help")
        self.add_option(
            "list",
            Option(
                Option.BOOLEAN,
                "l",
                "Input",
                "List input. Lines in each <query> specify paths to "
                "sequence files, one per line. The reference file is not "
                "affected.",
                "",
            ),
        )
        self.add_option(
            "comment",
            Option(
                Option.BOOLEAN,
                "C",
                "Output",
                "Use comment fields for sequence names instead of IDs.",
                "",
            ),
        )
        self.add_option(
            "edge",
            Option(
                Option.BOOLEAN,
                "E",
                "Output",
                "Output edge list instead of Phylip matrix, with fields "
                "[seq1, seq2, dist, p-val, shared-hashes].",
                "",
            ),
        )
        self.add_option(
            "pvalue",
            Option(
                Option.NUMBER,
                "v",
                "Output",
                "Maximum p-value to report in edge list. Implies -E.",
                "1.0",
                0.0,
                1.0,
            ),
        )
        self.add_option(
            "distance",
            Option(
                Option.NUMBER,
                "d",
                "Output",
                "Maximum distance to report in edge list. Implies -E.",
                "1.0",
                0.0,
                1.0,
            ),
        )
        self.use_sketch_options()

    def _run_streamed(
        self, sketch, refs, H, N, cap, device, out, edge, comment,
        pvalue_max, distance_max,
    ) -> float:
        """Stream the lower triangle in bounded memory.

        Row stripes of device compute stay one step ahead of host
        formatting (``stream_pair_stripes``); PHYLIP cell text goes
        through the memoized native formatter.  Replaces the full
        ``[N, N]`` host matrices that made the 100k-genome north star
        impossible (reference streams per pair block,
        ``CommandTriangle.cpp:131-198``).  Returns the max p-value.
        """
        from mash_tpu_torch.native import DistFormatter

        n = len(refs)
        k = sketch.params.kmer_size
        kmer_space = sketch.params.kmer_space
        lengths = np.array([r.length for r in refs], dtype=np.float64)
        names = [
            (r.comment if comment else r.name) for r in refs
        ]
        fmt = DistFormatter(k, cap)
        pvalue_peak = 0.0
        saw_zero_common = False

        for i0, stripe in stream_pair_stripes(
            H, N, H, N, cap, device, triangle=True,
            stripe_filter=mh.owns_stripe,
        ):
            rows = stripe.shape[0]
            i1 = min(i0 + rows, n)
            if i1 <= i0:
                continue
            common = (stripe & np.uint32(0xFFFF)).astype(np.int64)
            denom = (stripe >> np.uint32(16)).astype(np.int64)
            # sub-diagonal mask for this stripe
            cols = stripe.shape[1]
            sub = (
                np.arange(cols)[None, :]
                < np.arange(i0, i0 + rows)[:, None]
            )
            sub[i1 - i0 :, :] = False
            if not saw_zero_common and np.any(sub & (common == 0)):
                saw_zero_common = True  # pValue(0) == 1, the max
                pvalue_peak = 1.0
            # stripe-level p-values only feed the "Max p-value" report,
            # which edge mode never prints — the per-row loop computes
            # its own for output (avoid doing the scipy work twice)
            need_p = (not edge) and not saw_zero_common
            if need_p:
                nz = sub & (common > 0)
                ii, jj = np.nonzero(nz)
                pv = stats.pair_pvalue_array(
                    common[nz],
                    lengths[jj],
                    lengths[i0 + ii],
                    kmer_space,
                    denom[nz],
                )
                if pv.size:
                    pvalue_peak = max(pvalue_peak, float(pv.max()))
            for r in range(max(i0, 1) - i0, i1 - i0):
                i = i0 + r
                if edge:
                    crow = common[r, :i]
                    drow_v = stats.mash_distance_array(
                        crow, denom[r, :i], k
                    )
                    prow = np.ones(i, dtype=np.float64)
                    nzr = crow > 0
                    if nzr.any():
                        prow[nzr] = stats.pair_pvalue_array(
                            crow[nzr],
                            lengths[:i][nzr],
                            np.full(int(nzr.sum()), lengths[i]),
                            kmer_space,
                            denom[r, :i][nzr],
                        )
                    passed = np.ones(i, dtype=bool)
                    if distance_max >= 0:
                        passed &= drow_v <= distance_max
                    if pvalue_max >= 0:
                        passed &= prow <= pvalue_max
                    if not passed.any():
                        continue
                    idx = np.nonzero(passed)[0]
                    dstr = np.char.mod("%.6g", drow_v[idx])
                    pstr = np.char.mod("%.6g", prow[idx])
                    for t, j in enumerate(idx):
                        out.write(
                            "%s\t%s\t%s\t%s\t%d/%d\n"
                            % (
                                names[i],
                                names[j],
                                dstr[t],
                                pstr[t],
                                int(common[r, j]),
                                int(denom[r, j]),
                            )
                        )
                else:
                    out.write(names[i])
                    out.write(
                        fmt.phylip_cells(stripe[r, :i]).decode("ascii")
                    )
                    out.write("\n")
        return mh.max_across_hosts(pvalue_peak)

    def run(self) -> int:
        if len(self.arguments) < 1 or self.get_option("help").active:
            self.print_help()
            return 0

        err = sys.stderr
        out = sys.stdout
        comment = self.get_option("comment").active
        edge = self.get_option("edge").active
        pvalue_max = self.get_option("pvalue").get_argument_as_number()
        distance_max = self.get_option("distance").get_argument_as_number()
        if (
            self.get_option("pvalue").active
            or self.get_option("distance").active
        ):
            edge = True

        params = sketch_parameter_setup(self)
        if params is None:
            return 1
        if len(self.arguments) == 1 and not self.get_option("list").active:
            params.concatenated = False

        query_files = []
        for arg in self.arguments:
            if self.get_option("list").active:
                query_files.extend(split_file(arg))
            else:
                query_files.append(arg)

        device = resolve_device()
        sketch = init_from_files(query_files, params, device=device)

        # adopted kmer space, as in the reference
        # (CommandTriangle.cpp:103: sketch.getKmerSpace())
        length_threshold = (
            params.warning * sketch.params.kmer_space
            / (1.0 - params.warning)
        )
        warning_count = 0
        length_max = 0
        length_max_name = ""
        random_chance = 0.0
        k_min = 0
        for i, ref in enumerate(sketch.references):
            if ref.length > length_threshold:
                if warning_count == 0 or ref.length > length_max:
                    length_max = ref.length
                    length_max_name = ref.name
                    random_chance = sketch.random_kmer_chance(i)
                    k_min = sketch.min_kmer_size(i)
                warning_count += 1

        refs = sketch.references
        n = len(refs)
        rank0 = mh.process_index() == 0
        if not edge and rank0:
            # per-process outputs concatenate in stripe order, so the
            # header block appears once
            out.write("\t%d\n" % n)
            out.write(
                (refs[0].comment if comment else refs[0].name) + "\n"
            )

        cap = sketch.params.min_hashes_per_window
        width = max(
            cap, max((len(r.hashes) for r in refs), default=1)
        )
        H, N = pad_sketches([r.hashes for r in refs], width)

        if n > STREAM_MIN_SKETCHES and cap < 65536:
            pvalue_peak = self._run_streamed(
                sketch, refs, H, N, cap, device, out, edge, comment,
                pvalue_max, distance_max,
            )
            if not edge and rank0:
                err.write("Max p-value: %s\n" % cpp_double(pvalue_peak))
            if warning_count > 0 and not params.reads and rank0:
                warn_kmer_size(
                    params, self, length_max, length_max_name,
                    random_chance, k_min, warning_count,
                )
            return 0

        if not rank0:
            return 0  # small triangles: rank 0 computes and writes all

        if n > STREAM_MIN_SKETCHES:
            # the streamed path needs 16-bit cell packing (cap < 65536)
            # — warn before materializing O(N^2) host matrices
            err.write(
                "WARNING: sketch size %d disables the streamed "
                "triangle (needs < 65536); this run holds the full "
                "%dx%d matrix in memory.\n" % (cap, n, n)
            )

        common, denom = common_denom_tiled(
            H, N, H, N, cap, device, use64=sketch.params.use64
        )

        k = sketch.params.kmer_size
        kmer_space = sketch.params.kmer_space
        dist = stats.mash_distance_array(common, denom, k)
        lengths = np.array(
            [r.length for r in refs], dtype=np.float64
        )
        pvals = stats.pair_pvalue_array(
            common, lengths[None, :], lengths[:, None], kmer_space, denom
        )

        # Vectorized formatting: np.char.mod is C printf "%.6g", the
        # same 6-significant-digit form as cpp_double for finite values
        # (distances are clamped to [0,1], p-values to [0,1]); per-cell
        # python formatting would dominate large-N triangles.
        pvalue_peak = 0.0
        for i in range(1, n):
            ri = refs[i]
            drow = dist[i, :i]
            prow = pvals[i, :i]
            if len(prow):
                pvalue_peak = max(pvalue_peak, float(prow.max()))
            if edge:
                passed = np.ones(i, dtype=bool)
                if distance_max >= 0:
                    passed &= drow <= distance_max
                if pvalue_max >= 0:
                    passed &= prow <= pvalue_max
                if not passed.any():
                    continue
                idx = np.nonzero(passed)[0]
                dstr = np.char.mod("%.6g", drow[idx])
                pstr = np.char.mod("%.6g", prow[idx])
                name_i = ri.comment if comment else ri.name
                for t, j in enumerate(idx):
                    rj = refs[j]
                    out.write(
                        "%s\t%s\t%s\t%s\t%d/%d\n"
                        % (
                            name_i,
                            rj.comment if comment else rj.name,
                            dstr[t],
                            pstr[t],
                            int(common[i, j]),
                            int(denom[i, j]),
                        )
                    )
            else:
                out.write(ri.comment if comment else ri.name)
                if i:
                    out.write("\t")
                    out.write("\t".join(np.char.mod("%.6g", drow)))
                out.write("\n")

        if not edge:
            err.write("Max p-value: %s\n" % cpp_double(pvalue_peak))

        if warning_count > 0 and not params.reads:
            warn_kmer_size(
                params,
                self,
                length_max,
                length_max_name,
                random_chance,
                k_min,
                warning_count,
            )
        return 0
