"""Tiled ("dice") inference with a trained generator, TIFF in and out, with
post-processing, HTML galleries and PSNR/SSIM against a ground truth: the
port of the JAX package's ``test_dice.py``.

    python -m neuroclear_tpu_torch.test_dice --dataroot <dir> --name <exp> \
        --checkpoints_dir <dir> --results_dir <dir> --model_suffix _A \
        --load_iter <N> --dice_size 120 120 120 --overlap 15 --border_cut 10 \
        --save_volume [--save_projections] [--save_slices] [--skip_real] \
        [--normalize_intensity] [--dataroot_gt <dir>] [--device cpu] \
        [--legacy_pipeline] [--repetition] [--histogram_match]

It reads the first volume under ``--dataroot`` (uncompressed TIFF or
``.npy``), loads ``{suffix}_net_G{model_suffix}.npz`` (the JAX checkpoint
format; with ``--model`` a GAN model's name, that model's
``{suffix}_net_G_A.npz`` and ``_G_B.npz``, and infers with G_A), runs on the card unless ``--device cpu`` is given, and writes under
``<results_dir>/<name>/<phase>_<epoch>[_iter<N>]/`` what the JAX CLI writes:
the galleries ``index.html`` and ``index_wholeimg.html`` with their PNG
thumbnails under ``images/``, ``volumes/``, ``projections/``, ``images/``
slices and ``metrics.txt``.  ``--netG`` and ``--norm`` name the generator
(any 3D one-output net of the zoo; ``unet_vanilla`` needs tiles that are
multiples of 8); ``--eval`` switches a batch-norm generator to its running
statistics, without it every tile batch (or cube) is normalised by its own
statistics, as in JAX.  By default the tiles stream through the fused
pipeline on the device (``run_fused``, ``--precision`` bfloat16);
``--legacy_pipeline``, or ``--histogram_match``, which needs it, runs each
cube through the model on its own in float32 and assembles the cubes on the
host (``run_legacy``).  ``NEUROCLEAR_PALLAS_CONV=1`` routes the generator's
half-resolution bf16 convs through the dense-K conv kernel;
``NEUROCLEAR_PALLAS_WCONV`` set to anything but ``1`` sends its two
full-resolution 64-output convs to cuDNN instead of the W-pair kernel.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from . import resolve_device
from .data import create_dataset, find_dataset_using_name
from .data.image_folder import make_dataset
from .models.test_model import TestModel
from .options import device_of, test_options
from .parallel import metrics as device_metrics
from .parallel.dice_infer import DiceInferencePipeline
from .utils import html, imageops, tiffio
from .utils.assemble import Assemble_Dice
from .utils.visualizer import save_images


def web_dir_of(opt) -> str:
    if opt.data_name is None:
        web_dir = os.path.join(opt.results_dir, opt.name, f"{opt.phase}_{opt.epoch}")
    else:
        web_dir = os.path.join(opt.results_dir, opt.data_name + "_by_" + opt.name,
                               f"{opt.phase}_{opt.epoch}")
    if opt.load_iter > 0:
        web_dir = f"{web_dir}_iter{opt.load_iter}"
    return web_dir


def _volume_out_path(opt, web_dir: str) -> str:
    if opt.load_iter > 0:
        return web_dir + "/volumes/output_volume_xy-view_iter-" + str(opt.load_iter) + ".tif"
    return web_dir + "/volumes/output_volume_xy-view_epoch-" + str(opt.epoch) + ".tif"


def parse_options(argv=None):
    """The options, with the test parameters that the JAX CLI hard-codes;
    the options dump holds them as parsed, as the JAX CLI's does."""
    opt = test_options.parse(argv)
    opt.device = resolve_device(device_of(opt))
    test_options.print_options(opt)
    opt.num_threads = 0
    opt.batch_size = 1
    opt.serial_batches = True
    opt.no_flip = True
    return opt


def main(argv=None) -> dict:
    """Run the CLI.  Returns {"web_dir", "fake", "real" (the post-processed
    volumes; "real" is None when the per-cube loop skipped it), "fake_streamed"
    (the path written during the harvest, or None), "seconds" (inference and
    assembly wall time), "voxels", "metrics" (None without --dataroot_gt),
    "loaded" (the paths of the checkpoints loaded, the generator's first)}."""
    opt = parse_options(argv)
    device = opt.device
    # f32 convs in full f32, as the JAX package's HIGHEST precision
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    dataset = find_dataset_using_name(opt.dataset_mode)(opt)
    print("original dataset_shape: " + str(dataset.size_original()), flush=True)
    model = TestModel(opt, device)
    model.setup(opt)
    web_dir = web_dir_of(opt)
    print("creating web directory", web_dir, flush=True)
    webpage = html.HTML(web_dir, "Experiment = %s, Phase = %s, Epoch = %s"
                        % (opt.name, opt.phase, opt.epoch))

    use_legacy = opt.legacy_pipeline or opt.histogram_match
    t0 = time.perf_counter()
    if use_legacy:
        img_whole_dict = run_legacy(opt, model, dataset)
    else:
        img_whole_dict = run_fused(opt, model, dataset, web_dir, device)
    dt = time.perf_counter() - t0
    n_vox = int(np.prod(dataset.size_original()))
    print(f"Inference+assembly: {dt:.3f}s ({n_vox / max(dt, 1e-9):.4g} voxel/s, {device}, "
          f"{'per-cube loop' if use_legacy else 'fused pipeline'})", flush=True)
    print("Image volume re-assembled.")
    print("re-merged image shape: {}".format(img_whole_dict["fake"].shape), flush=True)

    populate_webpages(opt, web_dir, webpage, img_whole_dict)
    save_outputs(opt, web_dir, img_whole_dict)
    res = compute_gt_metrics(opt, web_dir, img_whole_dict, device)
    print("----Test done----", flush=True)
    return {"web_dir": web_dir, "fake": img_whole_dict["fake"],
            "real": img_whole_dict.get("real"),
            "fake_streamed": img_whole_dict.get("fake_streamed"), "seconds": dt,
            "voxels": n_vox, "metrics": res, "loaded": model.loaded}


def populate_webpages(opt, web_dir, webpage, img_whole_dict) -> None:
    """The two galleries: ``index.html`` with about 16 xy slices of the output
    (and of the input unless --skip_real), ``index_wholeimg.html`` with the
    maximum projections along each axis."""
    fake = img_whole_dict["fake"]
    real = img_whole_dict.get("real")

    n = fake.shape[0]
    step = max(1, n // 16)
    for i in range(0, n, step):
        visuals = {"output_xy": fake[i]}
        if real is not None and not opt.skip_real:
            visuals["input_xy"] = real[i]
        save_images(webpage, visuals, f"slice_z{i:04d}.tif")
    webpage.save()

    wholepage = html.HTML(web_dir, "Whole_img: Experiment = %s, Phase = %s, "
                          "Epoch = %s" % (opt.name, opt.phase, opt.epoch))
    mips = {}
    for plane, ax in (("xy", 0), ("xz", 1), ("yz", 2)):
        mips[f"output_{plane}_mip"] = np.amax(fake, axis=ax)
        if real is not None and not opt.skip_real:
            mips[f"input_{plane}_mip"] = np.amax(real, axis=ax)
    save_images(wholepage, mips, "whole_volume.tif", width=384)
    wholepage.save("index_wholeimg.html")


def run_fused(opt, model, dataset, web_dir, device) -> dict:
    """The tile pipeline on the device, then the host post-processing."""
    vol_padded = dataset.volume  # dicing-padded, not border-padded
    inv_scale = imageops.dtype_inv_scale(vol_padded.dtype)
    # The percentile normalisation is taken on the PADDED volume and the crop
    # comes after it, so the device crops only when normalize_intensity is off.
    out_dtype = {"uint8": np.uint8, "uint16": np.uint16}.get(opt.data_type)
    orig = None if opt.normalize_intensity else dataset.size_original()
    if opt.eval:
        model.eval()
    pipe = DiceInferencePipeline(
        model.netG, dataset.grid, inv_scale, tile_batch=opt.tile_batch,
        repetition=opt.repetition, precision=opt.precision, out_dtype=out_dtype,
        orig_shape=orig, device=device)

    # When the emitted rows are the final bytes (cast on the device, no
    # percentile stretch pending), the output TIFF is written as the rows
    # come back; the file is the one save_outputs would write, which then
    # skips the rewrite.
    writer = stream_path = None
    if (opt.save_volume and not opt.normalize_intensity and out_dtype is not None
            and tiffio.StreamingTiffWriter.fits(orig, out_dtype)):
        stream_path = _volume_out_path(opt, web_dir)
        writer = tiffio.StreamingTiffWriter(stream_path, orig, out_dtype)
    if writer is not None:
        with writer:
            fake = pipe.run_streaming(vol_padded, on_rows=writer.write_rows)
    else:
        fake = pipe.run_streaming(vol_padded)

    # 'real' is always assembled: --skip_real only gates saving it, and the
    # metrics read it
    out = {"fake_streamed": stream_path}
    real = np.asarray(vol_padded, np.float32) * inv_scale
    out["real"] = _postprocess(real, opt, dataset.size_original())
    out["fake"] = _postprocess(fake, opt, dataset.size_original())
    return out


def _postprocess(vol, opt, orig_shape):
    """normalize_intensity, then the dtype cast, then the crop of the dicing
    pad.  Takes a [0, 1] float volume or one already cast on the device (the
    percentiles then run on the quantised grid)."""
    scale = {"uint8": 255.0, "uint16": 2.0 ** 16 - 1}.get(opt.data_type, 1.0)
    if opt.normalize_intensity:
        vol_f32 = (vol.astype(np.float32) / scale
                   if np.issubdtype(vol.dtype, np.integer) else vol)
        p1, p99 = np.percentile(vol_f32, tuple(opt.sat_level))
        vol = imageops.rescale_intensity(vol_f32, in_range=(p1, p99))
    if not np.issubdtype(vol.dtype, np.integer):
        if opt.data_type == "uint8":
            vol = (vol * 255).astype(np.uint8)
        elif opt.data_type == "uint16":
            vol = (vol * (2 ** 16 - 1)).astype(np.uint16)
    oz, oy, ox = orig_shape
    return vol[:oz, :oy, :ox]


def run_legacy(opt, model, dataset_probe) -> dict:
    """The per-cube loop: each cube from the loader through the model on its
    own (float32), both visuals back to the host, then ``Assemble_Dice``;
    with --repetition each cube also runs flipped along each axis and the
    unflipped outputs are averaged."""
    dataset = create_dataset(opt)
    dice_assembly = Assemble_Dice(opt, dataset=dataset_probe)
    print("whole Image size: {}".format(dice_assembly.image_size))
    print("Whole image step counts y,x,z: {}".format(
        (dice_assembly.y_steps, dice_assembly.x_steps, dice_assembly.z_steps)))

    def host_visuals():
        return {k: v.cpu().numpy() for k, v in model.get_current_visuals().items()}

    if opt.eval:
        model.eval()
    for data_i in dataset:
        model.set_input(data_i)
        if opt.repetition:
            variants = dice_assembly.varycubeinput(
                {"A": model.real.cpu().numpy(), "A_paths": data_i["A_paths"]})
            outs = []
            for v in variants:
                model.set_input(v)
                model.test()
                outs.append(host_visuals())
            visuals = dice_assembly.combinecube(outs)
        else:
            model.test()
            visuals = host_visuals()
        dice_assembly.addToStack(visuals)
    print("Inference Done. ")
    dice_assembly.assemble_all()
    return dice_assembly.getDict()


def save_outputs(opt, web_dir, img_whole_dict) -> None:
    fake_volume = img_whole_dict["fake"]
    if not opt.skip_real:
        real_volume = img_whole_dict["real"]
        print("Input data type is: " + str(real_volume.dtype))
    print("Output data type is: " + str(fake_volume.dtype))

    if opt.save_volume:
        os.makedirs(web_dir + "/volumes", exist_ok=True)
        out_path = _volume_out_path(opt, web_dir)
        if img_whole_dict.get("fake_streamed") != out_path:
            tiffio.imwrite(out_path, fake_volume)
        print("Output volume is saved as a tiff file. ")
        if not opt.skip_real:
            tiffio.imwrite(web_dir + "/volumes/input_volume_xy-view.tif", real_volume)
            print("Input volume is saved as a tiff file. ")

    if opt.save_projections:
        os.makedirs(web_dir + "/projections", exist_ok=True)
        # the original CLI's fixed crop windows [:, 800:1100, :] and
        # [:, :, 200:500], applied only where they fit
        z, y, x = fake_volume.shape
        yz_win = slice(800, 1100) if y >= 1100 else slice(None)
        xz_win = slice(200, 500) if x >= 500 else slice(None)
        tiffio.imwrite(web_dir + f"/projections/fake_xy_proj_epoch-{opt.epoch}.tif",
                       np.amax(fake_volume, axis=0))
        tiffio.imwrite(web_dir + f"/projections/fake_xz_proj_epoch-{opt.epoch}.tif",
                       np.amax(fake_volume[:, yz_win, :], axis=1))
        tiffio.imwrite(web_dir + f"/projections/fake_yz_proj_epoch-{opt.epoch}.tif",
                       np.amax(fake_volume[:, :, xz_win], axis=2))
        if not opt.skip_real:
            tiffio.imwrite(web_dir + "/projections/real_xy_proj.tif", np.amax(real_volume, axis=0))
            tiffio.imwrite(web_dir + "/projections/real_xz_proj.tif", np.amax(real_volume, axis=1))
            tiffio.imwrite(web_dir + "/projections/real_yz_proj.tif", np.amax(real_volume, axis=2))

    if opt.save_slices:
        for plane in ("xy", "xz", "yz"):
            os.makedirs(web_dir + f"/images/output_{plane}", exist_ok=True)
            if not opt.skip_real:
                os.makedirs(web_dir + f"/images/input_{plane}", exist_ok=True)
        for plane, ax in (("yz", 2), ("xz", 1), ("xy", 0)):
            for i in range(fake_volume.shape[ax]):
                tiffio.imwrite(web_dir + f"/images/output_{plane}/output_{plane}_{i}.tif",
                               np.take(fake_volume, i, axis=ax))
                if not opt.skip_real:
                    tiffio.imwrite(web_dir + f"/images/input_{plane}/input_{plane}_{i}.tif",
                                   np.take(real_volume, i, axis=ax))


def host_metrics(real_volume, fake_volume, gt_volume) -> dict:
    """The protocol on the host in float64: standardize + normalize to uint8
    twice, as the original CLI does, then PSNR and SSIM at data range 255."""
    for _ in range(2):
        real_volume = imageops.normalize(imageops.standardize(real_volume), data_type=np.uint8)
        fake_volume = imageops.normalize(imageops.standardize(fake_volume), data_type=np.uint8)
        gt_volume = imageops.normalize(imageops.standardize(gt_volume), data_type=np.uint8)
    return {"psnr_input": imageops.get_psnr(real_volume, gt_volume, 255),
            "psnr_output": imageops.get_psnr(fake_volume, gt_volume, 255),
            "ssim_input": imageops.get_ssim(real_volume, gt_volume, 255),
            "ssim_output": imageops.get_ssim(fake_volume, gt_volume, 255)}


def compute_gt_metrics(opt, web_dir, img_whole_dict, device):
    """PSNR and SSIM of the input and the output against the ground truth,
    appended to ``metrics.txt``.  The device path takes uint8 and uint16
    volumes unless ``NEUROCLEAR_DEVICE_METRICS=0``; float volumes take the
    host path.  A failure of the device path raises: there is no fallback."""
    if opt.dataroot_gt is None:
        return None
    gt_volume = tiffio.imread(make_dataset(opt.dataroot_gt, 1)[0])
    print("Calculating PSNR for the whole image volume...")
    fake_volume = img_whole_dict["fake"]
    real_volume = img_whole_dict["real"]  # a KeyError when the per-cube loop skipped it, as in JAX
    if device_metrics.enabled() and device_metrics.supported(real_volume, fake_volume, gt_volume):
        print(f"metrics: slab-streamed on {device}")
        res = device_metrics.protocol_metrics(real_volume, fake_volume, gt_volume, device=device)
    else:
        print("metrics: host float64")
        res = host_metrics(real_volume, fake_volume, gt_volume)
    print("Metrics are calculated.")

    message = "Experiment Name: " + opt.name + "\n"
    message += "---------------------------------------------------------\n"
    message += "\nWhole_volume\n"
    message += "---------------------------------------------------------\n"
    message += "Network Input vs. Groundtruth\n"
    message += "(psnr: %.4f) \n" % res["psnr_input"]
    message += "(ssim: %.4f) \n" % res["ssim_input"]
    message += "---------------------------------------------------------\n"
    message += "Network Output vs. Groundtruth\n"
    message += "(psnr: %.4f) \n" % res["psnr_output"]
    message += "(ssim: %.4f) \n" % res["ssim_output"]
    message += "---------------------------------------------------------"
    print(message, flush=True)
    with open(os.path.join(web_dir, "metrics.txt"), "a") as metric_file:
        metric_file.write("%s\n" % message)
    return res


if __name__ == "__main__":
    main(sys.argv[1:])
