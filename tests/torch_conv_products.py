"""The conv trainers' matmul products, shared by the CPU plan tests and
the card tests (no JAX here: the card tests import it)."""


def conv_products():
    """Every distinct matmul product of one trainer step of LeNet-5
    b1024 and ResNet-18 b32 (chip_smoke.py's ``conv_products``), from the
    models' own plans: (label, M, K, N, A's strides, B's strides) with
    the strides of the views the autograd Function passes, the patch
    matrix at ops.conv.patch_pitch."""
    from lua_mapreduce_tpu_torch.models import lenet, resnet
    from lua_mapreduce_tpu_torch.ops.conv import _norm_padding, patch_pitch
    convs = []
    h, c_in = lenet.CIFAR_SHAPE[0], lenet.CIFAR_SHAPE[2]
    for i, (name, k, c_out) in enumerate(lenet._CONVS):
        convs.append((f"lenet {name}", 1024, h, c_in, c_out, k, 1, "VALID",
                      i > 0))
        h, c_in = (h - k + 1) // 2, c_out
    cfg = resnet.ResNetConfig.imagenet18()
    h = cfg.input_shape[0]
    convs.append(("resnet stem", 32, h, cfg.input_shape[2], cfg.widths[0],
                  7, 2, "SAME", False))
    h = -(-h // 4)
    for p, stride, needs_proj, c_in, c_out in resnet._block_plan(cfg):
        ho = -(-h // stride)
        convs.append((f"resnet {p} conv1", 32, h, c_in, c_out, 3, stride,
                      "SAME", True))
        convs.append((f"resnet {p} conv2", 32, ho, c_out, c_out, 3, 1,
                      "SAME", True))
        if needs_proj:
            convs.append((f"resnet {p} proj", 32, h, c_in, c_out, 1,
                          stride, "SAME", True))
        h = ho
    out = {}
    for label, n, h, c_in, c_out, k, s, padding, with_da in convs:
        ph, pw = _norm_padding(padding, k, k, h, h, s, s)
        m = n * ((h + sum(ph) - k) // s + 1) * ((h + sum(pw) - k) // s + 1)
        kk, pitch = k * k * c_in, patch_pitch(k * k * c_in)
        # identical shapes merged, under the first conv's label (as
        # chip_smoke.py's conv_cases does)
        out.setdefault((m, kk, c_out), (f"{label} fwd", (pitch, 1),
                                        (c_out, 1)))
        if with_da:
            out.setdefault((m, c_out, kk), (f"{label} dA", (c_out, 1),
                                            (1, c_out)))
        out.setdefault((kk, m, c_out), (f"{label} dB", (1, pitch),
                                        (c_out, 1)))
    return [(lbl, *shape, sa, sb) for shape, (lbl, sa, sb) in out.items()]
