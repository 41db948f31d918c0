"""Vision model family: the small conv classifier, on the card.

Counterpart of training_operator_tpu/trainer/vision.py: two 3x3 SAME convs
with ReLU and a 2x2 max pool each, a dense ReLU layer and a linear head,
trained with SGD + momentum (train.SGD) on `synthetic_mnist`. The images
come in NHWC, as in JAX; `F.conv2d` takes them as `images.permute(0, 3, 1,
2)`, an NCHW view whose memory is channels_last, so no copy is made.

Kept from JAX, and easy to get silently wrong:

- the flatten order: JAX flattens NHWC activations, so the rows of
  `w_dense` are ordered (h, w, c). The port permutes the pooled activations
  back to NHWC (a view of their channels_last memory) before the reshape, so
  `w_dense` keeps the JAX layout and the weight bridge (convert.py) only
  turns the conv kernels from HWIO into torch's OIHW;
- the precision: the convs and the dense layer run in `config.dtype` (bf16)
  with each bias cast to it and added after the product, as JAX does; the
  head multiplies the bf16 activations promoted to fp32 by the fp32
  `w_out` (JAX's bf16 x fp32 promotion), so the logits are fp32.

Under a mesh the parameters are replicated (JAX `vision_param_shardings`),
every rank takes its block of the batch's rows by its coordinate over
BATCH_AXES, the loss and accuracy are means over the global batch, and one
all-reduce over BATCH_AXES sums the gradients with them. Ranks that differ
only on another axis compute the same thing, as in JAX.

    python -m training_operator_tpu_torch.trainer.vision [--device cpu]

trains the default config at batch 256 for 60 steps (the counterpart of
examples/vision_mnist.py) and fails unless the final accuracy exceeds 0.9.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from training_operator_tpu_torch.trainer.collectives import all_reduce, reduce_sum
from training_operator_tpu_torch.trainer.mesh import BATCH_AXES, batch_rows
from training_operator_tpu_torch.trainer.model import resolve_device
from training_operator_tpu_torch.trainer.train import SGD, SGDState

@dataclass(frozen=True)
class VisionConfig:
    image_size: int = 28
    in_channels: int = 1
    n_classes: int = 10
    # Two conv stages then a dense head (the classic MNIST shape).
    channels: Tuple[int, int] = (32, 64)
    dense: int = 128
    dtype: torch.dtype = torch.bfloat16

    @property
    def flat_dim(self) -> int:
        # Two stride-2 pools halve the spatial dims twice.
        side = self.image_size // 4
        return side * side * self.channels[1]


def param_shapes(config: VisionConfig) -> Dict[str, Tuple[int, ...]]:
    """The port's parameter shapes: conv kernels OIHW, matrices [in, out]."""
    c = config
    return {
        "conv1": (c.channels[0], c.in_channels, 3, 3),
        "b1": (c.channels[0],),
        "conv2": (c.channels[1], c.channels[0], 3, 3),
        "b2": (c.channels[1],),
        "w_dense": (c.flat_dim, c.dense),
        "b_dense": (c.dense,),
        "w_out": (c.dense, c.n_classes),
        "b_out": (c.n_classes,),
    }


def init_vision_params(config: VisionConfig, generator: Optional[torch.Generator] = None,
                       device=None) -> Dict[str, torch.Tensor]:
    """He-normal weights over JAX's fan-in (kernel height x width x input
    channels for a conv) and zero biases, fp32, on the card unless `device`
    says otherwise. The generator must live on that device; by default one
    seeded with 0. The numbers differ from JAX's (another generator)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    params = {}
    for name, shape in param_shapes(config).items():
        if name.startswith("b"):
            p = torch.zeros(shape, device=device)
        else:
            fan_in = shape[0] if len(shape) == 2 else shape[1] * shape[2] * shape[3]
            p = torch.randn(shape, generator=generator, device=device) * (2.0 / fan_in) ** 0.5
        params[name] = p.requires_grad_()
    return params


def _conv_relu_pool(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    y = F.conv2d(x, w.to(x.dtype), padding=1) + b.to(x.dtype)[:, None, None]
    return F.max_pool2d(F.relu(y), 2)


def vision_forward(params: Dict[str, torch.Tensor], images: torch.Tensor,
                   config: VisionConfig) -> torch.Tensor:
    """images [B, H, W, C] -> logits [B, n_classes] fp32 (the rows given:
    under a mesh, this rank's)."""
    c = config
    x = images.to(c.dtype).permute(0, 3, 1, 2)  # NCHW view, channels_last memory
    x = _conv_relu_pool(x, params["conv1"], params["b1"])
    x = _conv_relu_pool(x, params["conv2"], params["b2"])
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # (h, w, c), JAX's order
    x = F.relu(x @ params["w_dense"].to(c.dtype) + params["b_dense"].to(c.dtype))
    return x.float() @ params["w_out"] + params["b_out"]


def local_rows(batch: Dict[str, torch.Tensor],
               mesh: Optional[DeviceMesh]) -> Dict[str, torch.Tensor]:
    """This rank's block of a global batch's rows (a view), by its
    coordinate over BATCH_AXES (`mesh.batch_rows`, one microbatch: the
    family has no pipeline); the whole batch without a mesh. Raises when
    the rows do not split."""
    if mesh is None:
        return batch
    rows = batch_rows(mesh, batch["labels"].shape[0], microbatches=1)
    return {k: v[rows[0]:rows[-1] + 1] for k, v in batch.items()}


def _sums(params, batch, config, mesh):
    """(summed cross-entropy, count of correct argmaxes) over this rank's
    rows of the global `batch`."""
    own = local_rows(batch, mesh)
    logits = vision_forward(params, own["images"], config)
    loss = F.cross_entropy(logits, own["labels"], reduction="sum")
    # torch.argmax takes the first maximum on ties, as jnp.argmax.
    correct = (logits.argmax(-1) == own["labels"]).sum()
    return loss, correct


def vision_loss_fn(params: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                   config: VisionConfig, mesh: Optional[DeviceMesh] = None) -> torch.Tensor:
    """Mean softmax cross-entropy in fp32 over the global batch
    ({images, labels}); under a mesh every rank computes its rows and the
    sum runs over BATCH_AXES (identity backward: each rank's gradient is its
    rows' share)."""
    loss, _ = _sums(params, batch, config, mesh)
    if mesh is not None:
        loss = reduce_sum(loss, mesh, BATCH_AXES)
    return loss / batch["labels"].shape[0]


def make_vision_train_step(config: VisionConfig, optimizer: SGD,
                           mesh: Optional[DeviceMesh] = None, device=None):
    """Returns `step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "accuracy"})`: cross-entropy and accuracy over the global
    batch, their gradient, and the optimizer's update in place (JAX donates
    both). The batch is the global one, on the step's device; under a mesh
    each rank computes its rows and one all-reduce over BATCH_AXES sums the
    gradients, the loss and the correct count."""
    device = resolve_device(device)

    def step(params: Dict[str, torch.Tensor], opt_state: SGDState,
             batch: Dict[str, torch.Tensor]):
        if batch["images"].device.type != device.type:
            raise ValueError(f"batch on {batch['images'].device}, step on {device}")
        rows = batch["labels"].shape[0]
        names = list(params)
        loss, correct = _sums(params, batch, config, mesh)
        grads = torch.autograd.grad(loss / rows, [params[n] for n in names])
        if mesh is not None:
            flat = torch.cat([g.reshape(-1) for g in grads]
                             + [loss.detach().reshape(1) / rows, correct.reshape(1).float()])
            all_reduce(flat, mesh, BATCH_AXES)
            *parts, (mean, correct) = flat.split([g.numel() for g in grads] + [2])
            grads = [f.view_as(g) for f, g in zip(parts, grads)]
        else:
            mean = loss.detach() / rows
        optimizer.update(dict(zip(names, grads)), opt_state, params)
        return params, opt_state, {"loss": mean, "accuracy": correct.float() / rows}

    return step


def digit_patches(labels: torch.Tensor, config: VisionConfig) -> torch.Tensor:
    """[n, H, W, C] fp32: 1 inside class k's 6x6 patch at (k*side, k*side),
    0 elsewhere (JAX synthetic_mnist's patch geometry)."""
    c = config
    side = max(1, (c.image_size - 8) // max(1, c.n_classes - 1))
    pos = (labels * side)[:, None, None, None]
    idx = torch.arange(c.image_size, device=labels.device)
    rows, cols = idx[None, :, None, None], idx[None, None, :, None]
    patch = (rows >= pos) & (rows < pos + 6) & (cols >= pos) & (cols < pos + 6)
    return patch.expand(-1, -1, -1, c.in_channels).float()


def synthetic_mnist(generator: torch.Generator, n: int,
                    config: VisionConfig) -> Dict[str, torch.Tensor]:
    """Separable synthetic digits on the generator's device: labels uniform
    over the classes (int64, torch's index type), images = 0.1 x normal
    noise + the label's bright patch (`digit_patches`), NHWC fp32."""
    c = config
    device = generator.device
    labels = torch.randint(0, c.n_classes, (n,), generator=generator, device=device)
    noise = 0.1 * torch.randn((n, c.image_size, c.image_size, c.in_channels),
                              generator=generator, device=device)
    return {"images": noise + digit_patches(labels, c), "labels": labels}


def train_synthetic(config: Optional[VisionConfig] = None, steps: int = 60, batch: int = 256,
                    device=None, log: Callable[[str], None] = print) -> Dict[str, list]:
    """examples/vision_mnist.py's run: params from seed 0, SGD(0.1, momentum
    0.9), one synthetic batch from seed 1 trained on for `steps` steps,
    logging every 10th step and the last. Returns `losses` and `accuracies`
    of every step, the trained `params`, the `batch` and, on the card,
    `step_ms`: each step's CUDA-event time."""
    config = config or VisionConfig()
    device = resolve_device(device)
    optimizer = SGD(0.1, momentum=0.9)
    params = init_vision_params(config, torch.Generator(device=device).manual_seed(0), device)
    opt_state = optimizer.init(params)
    step = make_vision_train_step(config, optimizer, device=device)
    data = synthetic_mnist(torch.Generator(device=device).manual_seed(1), batch, config)
    cuda = device.type == "cuda"
    metrics, events = [], []
    for i in range(steps):
        if cuda:
            events.append((torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True)))
            events[-1][0].record()
        params, opt_state, m = step(params, opt_state, data)
        if cuda:
            events[-1][1].record()
        metrics.append(m)
        if i % 10 == 0 or i == steps - 1:
            log(f"step {i:3d}  loss {float(m['loss']):.4f}  "
                f"accuracy {float(m['accuracy']):.3f}")
    out = {"losses": [float(m["loss"]) for m in metrics],
           "accuracies": [float(m["accuracy"]) for m in metrics],
           "params": params, "batch": data}
    if cuda:
        torch.cuda.synchronize(device)
        out["step_ms"] = [a.elapsed_time(b) for a, b in events]
    return out


def main(argv=None) -> None:
    import argparse

    parser = argparse.ArgumentParser(prog="python -m training_operator_tpu_torch.trainer.vision")
    parser.add_argument("--device", default=None, help="default: the card")
    args = parser.parse_args(argv)
    start = time.perf_counter()
    out = train_synthetic(device=args.device)
    if not out["accuracies"][-1] > 0.9:
        raise SystemExit(f"vision: final accuracy {out['accuracies'][-1]} is not above 0.9")
    print(f"vision: ok in {time.perf_counter() - start:.1f} s")


if __name__ == "__main__":
    main()
