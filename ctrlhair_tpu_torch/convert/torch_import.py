# Reference (PyTorch) checkpoint -> flax-layout parameter trees.
#
# The port's own copy of ctrlhair_tpu/convert/torch_import.py (numpy only):
# it maps the reference's state dicts onto the JAX package's flax trees,
# which convert.from_flax then maps onto the port's modules
# (convert/load.load_reference_params).  Kept as a copy, not an import: the
# port imports nothing of the JAX package.
#
# The reference ships four trained model families (SEAN pix2pix, BiSeNet,
# color_texture branch, shape branch; ref: hair_editor.py:45-119,
# my_parsing_util.py:38-44).  This module maps their state-dict layouts onto
# our flax pytrees so trained reference checkpoints drop into the TPU
# pipeline (the SSIM >= 0.99 gate of BASELINE.md).  Layout rules:
#   Linear      [out,in]        -> kernel [in,out]
#   Conv2d      [out,in,kh,kw]  -> kernel [kh,kw,in,out]
#   ConvT2d     [in,out,kh,kw]  -> kernel [kh,kw,in,out], spatially flipped
#   spectral    weight_orig,u,v -> weight_orig / sigma(u,v)
#   BatchNorm   weight/bias + running stats -> scale/bias + batch_stats
#   fc_mu0..18  19 x [512,512]  -> one stacked [19,512,512] einsum kernel
# Conversion correctness is pinned by tests/test_convert.py against live
# torch modules; tests/test_torch_torch_import.py holds this copy to it.

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np


def _np(t) -> np.ndarray:
    if hasattr(t, 'detach'):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float32)


def _prune_empty(tree):
    """Drop empty dict nodes so trees match flax's init structure exactly."""
    if isinstance(tree, dict):
        out = {k: _prune_empty(v) for k, v in tree.items()}
        return {k: v for k, v in out.items()
                if not (isinstance(v, dict) and not v)}
    return tree


def linear_kernel(weight) -> np.ndarray:
    return _np(weight).T


def conv_kernel(weight) -> np.ndarray:
    return _np(weight).transpose(2, 3, 1, 0)


def conv_transpose_kernel(weight) -> np.ndarray:
    """torch ConvTranspose2d [in,out,kh,kw] -> flax ConvTranspose HWIO.

    flax's ConvTranspose (transpose_kernel=False) slides the kernel without
    flipping, while torch's is the conv gradient — equivalent after a
    spatial flip.
    """
    w = _np(weight)                      # [in, out, kh, kw]
    w = w[:, :, ::-1, ::-1]
    return np.ascontiguousarray(w.transpose(2, 3, 0, 1))  # [kh,kw,in,out]


def spectral_weight(sd: Mapping[str, Any], prefix: str) -> np.ndarray:
    """Resolve a spectral-norm wrapped conv weight to its effective value.

    Handles both torch.nn.utils.spectral_norm ({p}.weight_orig/_u/_v) and a
    plain {p}.weight.
    """
    if f'{prefix}.weight' in sd:
        return _np(sd[f'{prefix}.weight'])
    w = _np(sd[f'{prefix}.weight_orig'])
    u = _np(sd[f'{prefix}.weight_u'])
    mat = w.reshape(w.shape[0], -1)
    if f'{prefix}.weight_v' in sd:
        v = _np(sd[f'{prefix}.weight_v'])
    else:
        v = mat.T @ u
        v /= (np.linalg.norm(v) + 1e-12)
    sigma = float(u @ (mat @ v))
    return w / sigma


def bn_variables(sd: Mapping[str, Any], prefix: str, affine: bool = True):
    """-> (params or None, batch_stats) for one (Sync)BatchNorm."""
    stats = {'mean': _np(sd[f'{prefix}.running_mean']),
             'var': _np(sd[f'{prefix}.running_var'])}
    if affine and f'{prefix}.weight' in sd:
        return ({'scale': _np(sd[f'{prefix}.weight']),
                 'bias': _np(sd[f'{prefix}.bias'])}, stats)
    return None, stats


# --------------------------------------------------------------------- SEAN

def convert_sean(netg_sd: Mapping[str, Any], ngf: int = 64,
                 semantic_nc: int = 19, style_dim: int = 512
                 ) -> Dict[str, Any]:
    """SEAN netG state dict -> our SEAN variables dict.

    Source layout: sean_codes SPADEGenerator (generator.py:24-54) with
    Zencoder inside; spectral-normed conv_0/conv_1/conv_s
    (architecture.py:40-45); per-ACE fc_mu<j> (normalization.py:191-215),
    SPADE mlps (:218-257), syncbatch param-free norms.
    """
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    # ---- Zencoder: sequential indices from its nn.Sequential layout
    # 1: conv3 stem, 4/7: downs, 10: convtranspose, 14: out conv
    z_p = {}
    z_p['stem'] = {'conv': {'kernel': conv_kernel(netg_sd['Zencoder.model.1.weight']),
                            'bias': _np(netg_sd['Zencoder.model.1.bias'])}}
    z_p['down_0'] = {'conv': {'kernel': conv_kernel(netg_sd['Zencoder.model.4.weight']),
                              'bias': _np(netg_sd['Zencoder.model.4.bias'])}}
    z_p['down_1'] = {'conv': {'kernel': conv_kernel(netg_sd['Zencoder.model.7.weight']),
                              'bias': _np(netg_sd['Zencoder.model.7.bias'])}}
    z_p['up_0'] = {'conv': {'kernel': conv_transpose_kernel(
        netg_sd['Zencoder.model.10.weight']),
        'bias': _np(netg_sd['Zencoder.model.10.bias'])}}
    z_p['out'] = {'conv': {'kernel': conv_kernel(netg_sd['Zencoder.model.14.weight']),
                           'bias': _np(netg_sd['Zencoder.model.14.bias'])}}
    params['zencoder'] = z_p

    # ---- generator
    g_p: Dict[str, Any] = {}
    g_s: Dict[str, Any] = {}
    g_p['fc'] = {'conv': {'kernel': conv_kernel(netg_sd['fc.weight']),
                          'bias': _np(netg_sd['fc.bias'])}}
    g_p['conv_img'] = {'conv': {
        'kernel': conv_kernel(netg_sd['conv_img.weight']),
        'bias': _np(netg_sd['conv_img.bias'])}}

    def convert_ace(src: str, use_styles: bool):
        p: Dict[str, Any] = {}
        s: Dict[str, Any] = {}
        _, s['pfn'] = bn_variables(netg_sd, f'{src}.param_free_norm',
                                   affine=False)
        p['spade'] = {
            'mlp_shared': {'conv': {
                'kernel': conv_kernel(netg_sd[f'{src}.Spade.mlp_shared.0.weight']),
                'bias': _np(netg_sd[f'{src}.Spade.mlp_shared.0.bias'])}},
            'mlp_gamma': {'conv': {
                'kernel': conv_kernel(netg_sd[f'{src}.Spade.mlp_gamma.weight']),
                'bias': _np(netg_sd[f'{src}.Spade.mlp_gamma.bias'])}},
            'mlp_beta': {'conv': {
                'kernel': conv_kernel(netg_sd[f'{src}.Spade.mlp_beta.weight']),
                'bias': _np(netg_sd[f'{src}.Spade.mlp_beta.bias'])}},
        }
        # (the reference SPADE declares a param_free_norm it never applies in
        # forward — nothing to convert for it)
        p['noise_var'] = _np(netg_sd[f'{src}.noise_var'])
        if use_styles:
            p['blending_gamma'] = _np(netg_sd[f'{src}.blending_gamma'])
            p['blending_beta'] = _np(netg_sd[f'{src}.blending_beta'])
            w = np.stack([linear_kernel(netg_sd[f'{src}.fc_mu{j}.weight'])
                          for j in range(semantic_nc)])
            b = np.stack([_np(netg_sd[f'{src}.fc_mu{j}.bias'])
                          for j in range(semantic_nc)])
            # our einsum 'rio,nri->nro' expects [r, in, out]
            p['fc_mu_kernel'] = w
            p['fc_mu_bias'] = b
            p['conv_gamma'] = {'conv': {
                'kernel': conv_kernel(netg_sd[f'{src}.conv_gamma.weight']),
                'bias': _np(netg_sd[f'{src}.conv_gamma.bias'])}}
            p['conv_beta'] = {'conv': {
                'kernel': conv_kernel(netg_sd[f'{src}.conv_beta.weight']),
                'bias': _np(netg_sd[f'{src}.conv_beta.bias'])}}
        return p, s

    blocks = ['head_0', 'G_middle_0', 'G_middle_1',
              'up_0', 'up_1', 'up_2', 'up_3']
    for name in blocks:
        use_styles = name != 'up_3'
        bp: Dict[str, Any] = {}
        bs: Dict[str, Any] = {}
        bp['ace_0'], bs['ace_0'] = convert_ace(f'{name}.ace_0', use_styles)
        bp['ace_1'], bs['ace_1'] = convert_ace(f'{name}.ace_1', use_styles)
        bp['conv_0'] = {'conv': {
            'kernel': conv_kernel(spectral_weight(netg_sd, f'{name}.conv_0')),
            'bias': _np(netg_sd[f'{name}.conv_0.bias'])}}
        bp['conv_1'] = {'conv': {
            'kernel': conv_kernel(spectral_weight(netg_sd, f'{name}.conv_1')),
            'bias': _np(netg_sd[f'{name}.conv_1.bias'])}}
        if f'{name}.conv_s.weight_orig' in netg_sd or \
                f'{name}.conv_s.weight' in netg_sd:
            bp['ace_s'], bs['ace_s'] = convert_ace(f'{name}.ace_s',
                                                   use_styles)
            bp['conv_s'] = {'conv': {'kernel': conv_kernel(
                spectral_weight(netg_sd, f'{name}.conv_s'))}}
        g_p[name] = bp
        g_s[name] = bs
    params['generator'] = g_p
    stats['generator'] = g_s
    return _prune_empty({'params': params, 'batch_stats': stats})


# ------------------------------------------------------------------ BiSeNet

def convert_bisenet(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """BiSeNet state dict (face_parsing_79999_iter.pth) -> our variables."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def cbr(src: str):
        p_, s_ = bn_variables(sd, f'{src}.bn')
        return ({'conv': {'kernel': conv_kernel(sd[f'{src}.conv.weight'])},
                 'bn': p_}, {'bn': s_})

    def conv_only(src: str):
        return {'kernel': conv_kernel(sd[f'{src}.weight'])}

    # resnet backbone
    rp: Dict[str, Any] = {}
    rs: Dict[str, Any] = {}
    rp['conv1'] = conv_only('cp.resnet.conv1')
    bnp, bns = bn_variables(sd, 'cp.resnet.bn1')
    rp['bn1'], rs['bn1'] = bnp, bns
    for li, layer in enumerate(['layer1', 'layer2', 'layer3', 'layer4']):
        for j in range(2):
            src = f'cp.resnet.{layer}.{j}'
            name = f'layer{li + 1}_{j}'
            bp: Dict[str, Any] = {}
            bs: Dict[str, Any] = {}
            b1p, b1s = bn_variables(sd, f'{src}.bn1')
            bp['cbr1'] = {'conv': {'kernel': conv_only(f'{src}.conv1')['kernel']},
                          'bn': b1p}
            bs['cbr1'] = {'bn': b1s}
            bp['conv2'] = conv_only(f'{src}.conv2')
            b2p, b2s = bn_variables(sd, f'{src}.bn2')
            bp['bn2'], bs['bn2'] = b2p, b2s
            if f'{src}.downsample.0.weight' in sd:
                bp['down_conv'] = conv_only(f'{src}.downsample.0')
                dp, dstats = bn_variables(sd, f'{src}.downsample.1')
                bp['down_bn'], bs['down_bn'] = dp, dstats
            rp[name], rs[name] = bp, bs
    params['resnet'], stats['resnet'] = rp, rs

    for ours, theirs in [('arm16', 'cp.arm16'), ('arm32', 'cp.arm32')]:
        cp, cs = cbr(f'{theirs}.conv')
        ap, astats = bn_variables(sd, f'{theirs}.bn_atten')
        params[ours] = {'conv': cp, 'conv_atten': conv_only(
            f'{theirs}.conv_atten'), 'bn_atten': ap}
        stats[ours] = {'conv': cs, 'bn_atten': astats}
    for ours, theirs in [('conv_head32', 'cp.conv_head32'),
                         ('conv_head16', 'cp.conv_head16'),
                         ('conv_avg', 'cp.conv_avg')]:
        p_, s_ = cbr(theirs)
        params[ours], stats[ours] = p_, s_
    fp, fs = cbr('ffm.convblk')
    params['ffm'] = {'convblk': fp, 'conv1': conv_only('ffm.conv1'),
                     'conv2': conv_only('ffm.conv2')}
    stats['ffm'] = {'convblk': fs}
    # main + auxiliary supervision heads (ref: model.py:237-246)
    for head in ['conv_out', 'conv_out16', 'conv_out32']:
        if f'{head}.conv.conv.weight' not in sd:
            continue
        op, ostats = cbr(f'{head}.conv')
        params[head] = {'conv': op,
                        'conv_out': conv_only(f'{head}.conv_out')}
        stats[head] = {'conv': ostats}
    return _prune_empty({'params': params, 'batch_stats': stats})


# -------------------------------------------------------- color_texture etc

def _linear_block(sd: Mapping[str, Any], src: str,
                  norm: str = 'none') -> Dict[str, Any]:
    p = {'fc': {'kernel': linear_kernel(sd[f'{src}.fc.weight']),
                'bias': _np(sd[f'{src}.fc.bias'])}}
    if norm == 'bn':
        bnp, _ = bn_variables(sd, f'{src}.norm')
        p['norm'] = {'bn': bnp}
    elif norm == 'ln':
        # torch nn.LayerNorm weight/bias -> flax LayerNorm scale/bias
        p['norm'] = {'scale': _np(sd[f'{src}.norm.weight']),
                     'bias': _np(sd[f'{src}.norm.bias'])}
    return p


def _mlp(sd: Mapping[str, Any], src: str, n_hidden: int,
         norm: str = 'none') -> Dict[str, Any]:
    """my_torchlib MLP (sequential LinearBlocks) -> our MLP module tree."""
    p = {}
    for i in range(n_hidden):
        p[f'layer_{i}'] = _linear_block(sd, f'{src}.{i}', norm)
    p['head'] = _linear_block(sd, f'{src}.{n_hidden}', 'none')
    return p


def _mlp_stats(sd: Mapping[str, Any], src: str, n_hidden: int
               ) -> Dict[str, Any]:
    s = {}
    for i in range(n_hidden):
        if f'{src}.{i}.norm.running_mean' in sd:
            _, stats = bn_variables(sd, f'{src}.{i}.norm')
            s[f'layer_{i}'] = {'norm': {'bn': stats}}
    return s


def convert_ct_generator(sd: Mapping[str, Any], hidden_layers: int = 4,
                         semantic=None) -> Dict[str, Any]:
    """EigenGenerator Model_G dict -> our params
    (ref layout: model_eigengan.py:34-60)."""
    p: Dict[str, Any] = {}
    p['main_in'] = {'kernel': linear_kernel(sd['main_layer_in.weight']),
                    'bias': _np(sd['main_layer_in.bias'])}
    for i in range(hidden_layers):
        p[f'subspace_{i}'] = {'U': _np(sd[f'subspaces.{i}.U']),
                              'L': _np(sd[f'subspaces.{i}.L']),
                              'mu': _np(sd[f'subspaces.{i}.mu'])}
        p[f'main_mid_{i}'] = {
            'kernel': linear_kernel(sd[f'main_layer_mid.{i}.1.weight']),
            'bias': _np(sd[f'main_layer_mid.{i}.1.bias'])}
    return {'params': p}


def convert_ct_discriminator(sd: Mapping[str, Any],
                             hidden_layers: int = 4) -> Dict[str, Any]:
    """CT Discriminator Model_D dict -> our params (ref: model.py:86-105)."""
    return {'params': {'net': _mlp(sd, 'net', hidden_layers)}}


def convert_predictor(sd: Mapping[str, Any], hidden_layers: int = 3,
                      norm: str = 'bn') -> Dict[str, Any]:
    """Predictor dict (ref: predictor_model.py:14-29)."""
    out = {'params': {'net': _mlp(sd, 'net', hidden_layers, norm)}}
    stats = _mlp_stats(sd, 'net', hidden_layers)
    if stats:
        out['batch_stats'] = {'net': stats}
    return out


# --------------------------------------------------------------- shape gen

def _linear_from_chw(weight, c: int, hw: int) -> np.ndarray:
    """Linear consuming a torch flatten(1) of an NCHW feature -> our kernel.

    torch flattens [N,C,H,W] -> [N, C*H*W] (channel-major); our NHWC reshape
    produces [N, H*W*C].  Permute the input axis accordingly
    (ref: shape_branch/model.py:96-100).
    """
    w = _np(weight)                               # [out, C*H*W]
    out_dim, fc_in = w.shape
    assert fc_in == c * hw * hw, (fc_in, c, hw)
    w = w.reshape(out_dim, c, hw, hw).transpose(0, 2, 3, 1)
    return w.reshape(out_dim, fc_in).T            # [H*W*C, out]


def _linear_to_chw(weight, bias, c: int, hw: int):
    """Linear whose torch output is reshaped to [N,C,H,W] -> our [N,H,W,C]
    reshape order: permute the OUTPUT axis (ref: model.py:140-141)."""
    w = _np(weight)                               # [C*H*W, in]
    b = _np(bias)
    w = w.reshape(c, hw, hw, -1).transpose(1, 2, 0, 3).reshape(w.shape[0], -1)
    b = b.reshape(c, hw, hw).transpose(1, 2, 0).reshape(-1)
    return {'fc': {'kernel': w.T, 'bias': b}}


def _mask_encoder(sd: Mapping[str, Any], src: str, layer_num: int,
                  vae: bool, norm: str = 'ln', img_size: int = 256,
                  hidden_in_channel: int = 32,
                  max_channel: int = 2048) -> Dict[str, Any]:
    p: Dict[str, Any] = {}
    for i in range(layer_num):
        blk = {'conv': {'conv': {
            'kernel': conv_kernel(sd[f'{src}.layers.{i}.conv.weight']),
            'bias': _np(sd[f'{src}.layers.{i}.conv.bias'])}}}
        if norm == 'ln' and f'{src}.layers.{i}.norm.gamma' in sd:
            blk['norm'] = {'gamma': _np(sd[f'{src}.layers.{i}.norm.gamma']),
                           'beta': _np(sd[f'{src}.layers.{i}.norm.beta'])}
        p[f'down_{i}'] = blk
    c = min(max_channel, 2 ** (layer_num - 1) * hidden_in_channel)
    hw = img_size // (2 ** layer_num)
    p['out'] = {'fc': {
        'kernel': _linear_from_chw(sd[f'{src}.out_layer.fc.weight'], c, hw),
        'bias': _np(sd[f'{src}.out_layer.fc.bias'])}}
    if vae:
        p['std_out'] = {'fc': {
            'kernel': _linear_from_chw(sd[f'{src}.std_out_layer.fc.weight'],
                                       c, hw),
            'bias': _np(sd[f'{src}.std_out_layer.fc.bias'])}}
    return p


def _mask_decoder(sd: Mapping[str, Any], src: str,
                  layer_num: int, norm: str = 'ln',
                  img_size: int = 256, max_channel: int = 2048
                  ) -> Dict[str, Any]:
    # decoder bottleneck: [in_ch, s, s] with in_ch = min(32*2^L, max)
    # (ref: shape_branch/model.py:120-123)
    in_ch = min(32 * 2 ** layer_num, max_channel)
    s = img_size // (2 ** layer_num)
    p: Dict[str, Any] = {'in_layer': _linear_to_chw(
        sd[f'{src}.in_layer.fc.weight'], sd[f'{src}.in_layer.fc.bias'],
        in_ch, s)}
    for i in range(layer_num):
        # decoder Sequential interleaves Upsample+ConvBlock: conv at 2i+1
        blk = {'conv': {'conv': {
            'kernel': conv_kernel(sd[f'{src}.layers.{2 * i + 1}.conv.weight']),
            'bias': _np(sd[f'{src}.layers.{2 * i + 1}.conv.bias'])}}}
        if norm == 'ln' and f'{src}.layers.{2 * i + 1}.norm.gamma' in sd:
            blk['norm'] = {
                'gamma': _np(sd[f'{src}.layers.{2 * i + 1}.norm.gamma']),
                'beta': _np(sd[f'{src}.layers.{2 * i + 1}.norm.beta'])}
        p[f'up_{i}'] = blk
    p['out'] = {'conv': {'conv': {
        'kernel': conv_kernel(sd[f'{src}.out_layer.conv.weight']),
        'bias': _np(sd[f'{src}.out_layer.conv.bias'])}}}
    return p


def convert_shape_generator(sd: Mapping[str, Any], layer_num: int = 7,
                            img_size: int = 256,
                            hidden_in_channel: int = 32,
                            max_channel: int = 2048) -> Dict[str, Any]:
    """Shape Generator Model_G (ref: shape_branch/model.py:146-162)."""
    return {'params': {
        'hair_encoder': _mask_encoder(
            sd, 'hair_encoder', layer_num, True, img_size=img_size,
            hidden_in_channel=hidden_in_channel, max_channel=max_channel),
        'face_encoder': _mask_encoder(
            sd, 'face_encoder', layer_num, False, img_size=img_size,
            hidden_in_channel=hidden_in_channel, max_channel=max_channel),
        'hair_decoder': _mask_decoder(sd, 'hair_decoder', layer_num,
                                      img_size=img_size,
                                      max_channel=max_channel),
        'face_decoder': _mask_decoder(sd, 'face_decoder', layer_num,
                                      img_size=img_size,
                                      max_channel=max_channel),
    }}


def strip_ddp_prefix(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """Drop a leading 'module.' from DDP-wrapped checkpoints
    (ref: hair_editor.py:66-68)."""
    if all(k.startswith('module.') for k in sd):
        return {k[7:]: v for k, v in sd.items()}
    return dict(sd)
