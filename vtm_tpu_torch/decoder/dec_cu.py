"""CU reconstruction of the port (intra and palette).

Subclass of vtm_tpu/decoder/dec_cu.py's CuReconstructor whose finish_slice
needs no MC batch: intra and palette CUs reconstruct on the host exactly as
in the reference, and an inter or IBC CU raises until MC is ported.
"""

from __future__ import annotations

from vtm_tpu.decoder import cs as D
from vtm_tpu.decoder import dec_cu as _ref


class CuReconstructor(_ref.CuReconstructor):
    def finish_slice(self):
        """Deferred sample reconstruction of the slice's CUs, in coding
        order (the reference's finish_slice without the MC batch)."""
        cus = getattr(self, "_pending", [])
        self._pending = []
        for cu in cus:
            if cu.pred_mode in (D.MODE_INTER, D.MODE_IBC):
                raise NotImplementedError("inter/IBC MC is not ported yet")
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
            else:
                self.recon_plt_cu(cu)
            if ibc:
                self._ibc_fill_buffer(cu)
