#!/usr/bin/env python3
'''Phase 24a's fp32 captioner cell of ``chip_smoke.py`` alone: graphed
bundles of the fp32 train step (B=32, Sa=256, Sv=96, Sc=22, flagship
widths) against eager steps from the same state, checked equal, then ms a
step of each, host clock, median of the alternating bundles.

    python3 step_ab.py

Runs from the root of a checkout on one CUDA device, with that checkout's
kernels. To compare two commits on one machine, run it in turns from the
root of each (``git archive`` of the other into a directory that
``.gitignore`` lists): parent, this, this, parent. Prints one line,
``STEP24A graphed <ms> eager <ms> ms a step (<card>, <power limit>)``.
'''
import torch

import chip_smoke as cs


def main():
    if not torch.cuda.is_available():
        raise SystemExit('step_ab: no CUDA device')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda:0')
    smi = cs.device_line()
    cap = cs.CapModelDims(voc_size=cs.VOC)
    batches = [cs.train_batch(240 + i, cs.TB, cs.SV, cs.SA, cs.TSC, cap)
               for i in range(cs.MULTISTEP_K)]

    def make():
        model = cs.BiModalTransformer(
            cap, device=dev,
            generator=torch.Generator(device=dev).manual_seed(24))
        state = cs.init_train_state(model, cs.build_optimizer(cs.TRAIN_CFG,
                                                              model),
                                    seed=24, ema=True)
        return state, cs.make_cap_train_step(
            cap, cs.SMOOTHING, cs.PAD, 'kernel', compute_dtype=torch.float32,
            ema_decay=cs.MULTISTEP_EMA)
    numbers, _ = cs.multistep_cell(
        '[24a] captioner float32', make, batches, cs.STEP_TOL,
        dict.fromkeys((cs.KERNEL, cs.KERNEL_DQ, cs.KERNEL_DKV),
                      cs.CALLS_PER_STEP), smi)
    print(f'STEP24A graphed {numbers["graphed_ms"]:.2f} eager '
          f'{numbers["eager_ms"]:.2f} ms a step ({smi})', flush=True)


if __name__ == '__main__':
    main()
