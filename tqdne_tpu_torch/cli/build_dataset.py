"""``raw_waveforms.h5`` -> ``preprocessed_waveforms.h5``: the port of
``tqdne_tpu/cli/build_dataset.py``.

The reference's ``experiments/build_dataset.py``: drop the records with
vs30 <= 0, copy each feature and the validity indices, z-score the stacked
features into ``normalized_features`` and transpose the waveforms (N, T, C)
-> (N, C, T) in batches with NaNs set to 0: the storage contract that
``data.dataset.Dataset`` reads.  numpy and ``h5py`` on the host:

    python -m tqdne_tpu_torch.cli.build_dataset --workdir W
"""

from __future__ import annotations

import argparse

import numpy as np

from tqdne_tpu_torch import configs


def run(workdir, batch_size: int = 1000) -> None:
    import h5py

    config = configs.Config(workdir=workdir)
    with h5py.File(config.original_datapath, "r") as f:
        mask = f["vs30"][:] > 0
        indices = np.arange(len(mask))[mask]
        with h5py.File(config.datapath, "w") as f_new:
            features = []
            for key in config.features_keys:
                print(key, f[key].shape)
                feature = f[key][mask]
                f_new.create_dataset(key, data=feature)
                features.append(feature)

            f_new.create_dataset("indices_valid_waveforms",
                                 data=f["indices_valid_waveforms"][mask])

            features = np.stack(features, axis=1)
            normalized = (features - features.mean(axis=0)) / features.std(axis=0)
            f_new.create_dataset("normalized_features", data=normalized)

            _, t, channels = f["waveforms"].shape
            f_new.create_dataset("waveforms", (len(indices), channels, t))
            for i in range(0, len(indices), batch_size):
                wf = f["waveforms"][indices[i : i + batch_size], ...]
                f_new["waveforms"][i : i + batch_size] = np.nan_to_num(np.swapaxes(wf, 1, 2))
                print(f"{min(i + batch_size, len(indices))}/{len(indices)}")


def main(argv=None):
    parser = argparse.ArgumentParser("tqdne_tpu_torch.cli.build_dataset",
                                     description=__doc__.split("\n\n")[0])
    parser.add_argument("--workdir", type=str, required=True,
                        help="working directory holding data/raw_waveforms.h5")
    args = parser.parse_args(argv)
    run(args.workdir)


if __name__ == "__main__":
    main()
