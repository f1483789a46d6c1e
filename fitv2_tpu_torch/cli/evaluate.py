"""CLI: ADM-style metrics (FID / sFID / IS / precision / recall) with the
PyTorch port.

    python -m fitv2_tpu_torch.cli.evaluate ref_batch.npz samples.npz \
        [--inception-weights pt_inception.safetensors [--weights-are-adm]] \
        [--batch-size 64] [--device cuda]

The flags are those of ``fitv2_tpu.cli.evaluate`` plus ``--device``. The
ref batch is an images npz (arr_0 uint8) or a precomputed-statistics npz
(mu/sigma [+ mu_s/sigma_s]), which gives FID, sFID and IS only. Prints one
JSON line; without --weights-are-adm the FID is comparable across this
pipeline only (``eval.evaluator.FID_COMPARABILITY_NOTE``).
"""

from __future__ import annotations

import argparse
import json


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('ref_batch', help='npz: arr_0 images, or mu/sigma stats')
    p.add_argument('sample_batch', help='npz with arr_0 uint8 images')
    p.add_argument('--inception-weights', default=None,
                   help='safetensors/pt InceptionV3 weights (pytorch-fid '
                        'layout); a seeded initialisation if omitted')
    p.add_argument('--weights-are-adm', action='store_true',
                   help='attest the weights are the converted ADM '
                        'TF-Inception weights (comparable to published '
                        'numbers)')
    p.add_argument('--batch-size', type=int, default=64)
    p.add_argument('--device', default='cuda',
                   help="torch device for InceptionV3 ('cuda' needs a card)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    import numpy as np

    from fitv2_tpu_torch.eval import statistics as stats
    from fitv2_tpu_torch.eval.evaluator import Evaluator

    ev = Evaluator(inception_weights=args.inception_weights,
                   batch_size=args.batch_size,
                   weights_are_adm=args.weights_are_adm, device=args.device)
    samp = ev.read_activations(args.sample_batch)

    ref_npz = np.load(args.ref_batch)
    if 'mu' in ref_npz.files:
        # precomputed reference statistics: no reference activations, so
        # no precision / recall
        mu, sigma = stats.activation_statistics(samp['pool3'])
        out = {'fid': stats.frechet_distance(
            ref_npz['mu'], ref_npz['sigma'], mu, sigma)}
        if 'mu_s' in ref_npz.files:
            mu_s, sigma_s = stats.activation_statistics(samp['spatial'])
            out['sfid'] = stats.frechet_distance(
                ref_npz['mu_s'], ref_npz['sigma_s'], mu_s, sigma_s)
        out['inception_score'] = stats.inception_score(samp['softmax'])
    else:
        ref = ev.read_activations(args.ref_batch)
        out = stats.compute_all_metrics(
            ref['pool3'], ref['spatial'], samp['pool3'], samp['spatial'],
            samp['softmax'])
    out['comparable_to_published'] = ev.comparable_to_published
    print(json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                      for k, v in out.items()}))


if __name__ == '__main__':
    main()
