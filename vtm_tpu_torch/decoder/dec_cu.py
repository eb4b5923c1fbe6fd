"""CU reconstruction of the port.

Subclass of vtm_tpu/decoder/dec_cu.py's CuReconstructor on an explicit
torch device.  Its finish_slice is the reference's (DecCu::decompressCtu
deferred to the end of the slice): every translational MC of the slice is
planned on one McBatch and runs as one kernel call per component class,
then DMVR and BDOF CUs run batched (decoder/refine.py), then CUs are
reconstructed on the host in coding order.  The batches are the port's
(ops/mc_kernel.py, ops/refine_kernel.py); everything else is vtm_tpu's.
"""

from __future__ import annotations

import torch

from vtm_tpu.decoder import cs as D
from vtm_tpu.decoder import dec_cu as _ref
from vtm_tpu.decoder import inter_cu
from vtm_tpu_torch.decoder import refine
from vtm_tpu_torch.ops.mc_kernel import McBatch


class CuReconstructor(_ref.CuReconstructor):
    def __init__(self, dcs: D.DecCodingStructure, planes, device: torch.device):
        super().__init__(dcs, planes)
        self.device = device

    def finish_slice(self):
        """Deferred sample reconstruction: plan all inter MC of the slice on
        one batch, run the batched kernels, then walk the CUs in coding
        order applying predictions and residuals (intra, IBC and palette
        stay order-dependent, on the host)."""
        cus = getattr(self, "_pending", [])
        self._pending = []
        batch = McBatch(self.bit_depth, self.device)
        fins = {}
        dmvr_jobs = []
        bdof_cus = []
        ref_results = {}
        for cu in cus:
            if cu.pred_mode in (D.MODE_INTER, D.MODE_IBC):
                p = inter_cu.plan_cu_mc(batch, self, cu)
                if isinstance(p, tuple):
                    if p[0] == "dmvr":
                        dmvr_jobs.append((cu, p[1]))
                    else:
                        bdof_cus.append(cu)
                    p = (lambda c=cu: ref_results[id(c)])
                fins[id(cu)] = p
        batch.execute()
        if dmvr_jobs:
            ref_results.update(refine.dmvr_batch(self, self.cs, dmvr_jobs))
        if bdof_cus:
            ref_results.update(refine.bdof_batch(self, self.cs, bdof_cus))
        ibc = self.cs.sps.ibc
        for cu in cus:
            if ibc:
                if getattr(cu, "_ibc_row_reset", False):
                    for b in self.ibc_buf:
                        b.fill(-1)
                if cu.blocks[0] is not None:
                    self._ibc_vpdu_reset(cu)
            if cu.pred_mode == D.MODE_INTRA:
                self.recon_intra_cu(cu)
            elif cu.pred_mode in (D.MODE_INTER, D.MODE_IBC):
                inter_cu.recon_inter_cu(self, cu, fins[id(cu)])
            else:
                self.recon_plt_cu(cu)
            if ibc:
                self._ibc_fill_buffer(cu)
