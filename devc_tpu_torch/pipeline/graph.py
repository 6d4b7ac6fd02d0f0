"""Scan mode: one frame step captured as a CUDA graph and replayed per
frame (the port's counterpart of devc_tpu's `_device_chunk_scan`, which
runs K frames as one lax.scan program).

A 432x768 frame step is some 500 kernel launches, and the host's time
to issue them shows as a gap between frames. `CapturedStep` records the
step once and replays it: one graph launch per frame, the recurrent carry
kept on the card. The caller hands it `chunk` frames at a time (one upload
and one download per chunk), and it replays the graph once per frame of
the chunk; a tail chunk replays only its valid frames.

Capture needs fixed addresses and no host syncs inside the step:
  * the uint8 frame and the carry are static buffers; the step reads them
    and its outputs land in tensors allocated once, during the capture,
    from the graph's private pool; the carry's update (a copy into its
    buffer) is part of the graph;
  * the exemplar state is held by the step function's closure, so it
    stays alive at its addresses for the graph's life;
  * one warm-up step runs on a side stream before the capture, so that
    everything done once (the kernel library's load, cudaFuncSetAttribute,
    cuBLAS / cuDNN handles, the colour constants' upload, the split
    convolutions' split weights) happens outside it. The side stream is
    one per card, shared by every capture: cuBLAS keeps a 32 MiB
    workspace for each stream it has run on and never frees it, so a new
    stream per capture grew a long-lived server's memory by 32 MiB with
    every scan-mode request.
The step may run its networks in bf16 (--bf16): the frame buffer stays
uint8 and the carry fp32, so the capture is the same.
cuDNN's autotuner stays off (`torch.backends.cudnn.benchmark` False), so
the eager and the captured step pick the same algorithms and give the
same bits. A capture that fails raises: there is no eager path in its
place.

Graph replays do not run the kernel wrappers' Python, so their
`.launches` counters count the warm-up and the capture only;
`kernel_launches` records what one replay launches.
"""

from __future__ import annotations

import torch

_SIDE_STREAMS: dict = {}  # device -> the warm-up stream of every capture


def _side_stream(device) -> torch.cuda.Stream:
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


class CapturedStep:
    """step(frame_u8, carry) -> (out_u8, new_carry), captured on the card.

    frame_shape: the uint8 frame's shape; carry: the initial carry (its
    shape and dtype fix the buffer's). `run(frames)` replays the graph
    once per frame of frames [K, *frame_shape] (on the card) and returns
    the outputs [K, *out_shape]; the carry runs on across calls.
    """

    def __init__(self, step, frame_shape, carry):
        from devc_tpu_torch.ops import conv_split, cuda_corr, fgs

        if carry.device.type != "cuda":
            raise ValueError("CapturedStep: the carry must be on the card")
        if torch.backends.cudnn.benchmark:
            raise RuntimeError("CapturedStep: cuDNN's autotuner is on; the "
                               "captured step could pick other algorithms "
                               "than the eager one")
        counters = (cuda_corr.corr_fwd, fgs.smooth_pass, fgs.tridiag_pcr,
                    conv_split.split_conv2d)
        device = carry.device
        with torch.inference_mode():
            self.frame = torch.zeros(frame_shape, dtype=torch.uint8,
                                     device=device)
            self.carry = carry.clone()
            side = _side_stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                step(self.frame, self.carry)
            torch.cuda.current_stream(device).wait_stream(side)
            before = [c.launches for c in counters]
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self.out, new_carry = step(self.frame, self.carry)
                self.carry.copy_(new_carry)
        self.kernel_launches = {c.__name__: c.launches - b
                                for c, b in zip(counters, before)}
        self.replays = 0

    def run(self, frames):
        """Replay once per frame of frames [K, *frame_shape] (uint8, on the
        card); returns [K, *out_shape] uint8 on the card."""
        with torch.inference_mode():
            outs = torch.empty((frames.shape[0], *self.out.shape),
                               dtype=self.out.dtype, device=self.out.device)
            for i in range(frames.shape[0]):
                self.frame.copy_(frames[i])
                self.graph.replay()
                outs[i].copy_(self.out)
            self.replays += frames.shape[0]
        return outs
