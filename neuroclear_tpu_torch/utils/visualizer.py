"""The port of ``neuroclear_tpu/utils/visualizer.py``.

``Visualizer`` is the trainers' reporting, for any model's losses and
visuals: console loss lines
and ``loss_log.txt`` in the JAX package's format, TIFF snapshots of the
visuals (through the port's own codec, ``utils/tiffio.py``) and an HTML page
of their middle slices as PNG (``web/index.html``, newest iteration first,
as the original repository's trainer kept it), both under ``web/`` unless
``--no_html`` (the JAX package's gate), and TensorBoard scalars, slice and
MIP figures, histograms and the options where ``torch.utils.tensorboard``
(and, for the figures, ``matplotlib``) import.
A sink that does not import is reported as off once; it is never a stand-in
for anything else, and nothing here catches an error of the training step.
The visuals are device tensors, read back only when a sink takes them.

``save_images`` fills an HTML gallery of the tiled inference (PNG
thumbnails through ``utils/png.py``) and ``save_test_metrics`` writes the
original's per-item ``metrics.txt`` lines.
"""

from __future__ import annotations

import os
import re
import time

import numpy as np

from . import html, tiffio
from .imageops import save_image, tensor2im


def _to_zyx(image) -> np.ndarray:
    """A (N, Z, Y, X, C) visual -> its first (Z, Y, X) volume, f32 numpy."""
    img = image.detach().float().cpu().numpy() if hasattr(image, "detach") else np.asarray(image)
    if img.ndim == 5:
        return img[0, ..., 0]
    if img.ndim == 4:
        return img[0] if img.shape[-1] != 1 else img[..., 0]
    return img


class Visualizer:
    def __init__(self, opt):
        self.opt = opt
        self.name = opt.name
        self.display_histogram = opt.display_histogram
        self.use_html = not opt.no_html
        self.web_dir = os.path.join(opt.checkpoints_dir, opt.name, "web")
        self.img_dir = os.path.join(self.web_dir, "images")
        if self.use_html:
            print(f"create web directory {self.web_dir}...")
            os.makedirs(self.img_dir, exist_ok=True)

        self.tb_writer = self.plt = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError as e:
            print(f"tensorboard unavailable ({e}); TB logging disabled")
        else:
            self.tb_dir = os.path.join(opt.checkpoints_dir, "tensorboard")
            print(f"create tensorboard directory {self.tb_dir}...")
            self.tb_writer = SummaryWriter(os.path.join(self.tb_dir, self.name))
            try:
                import matplotlib
            except ImportError as e:
                print(f"matplotlib unavailable ({e}); TB figures disabled")
            else:
                matplotlib.use("Agg")
                import matplotlib.pyplot as plt

                self.plt = plt

        self.log_name = os.path.join(opt.checkpoints_dir, opt.name, "loss_log.txt")
        os.makedirs(os.path.dirname(self.log_name), exist_ok=True)
        with open(self.log_name, "a") as log_file:
            now = time.strftime("%c")
            log_file.write(f"================ Training Loss ({now}) ================\n")

    def display_current_results(self, visuals, epoch):
        """Mid-volume slices and MIPs of each visual as TB figures."""
        if self.tb_writer is None or self.plt is None:
            return
        plt = self.plt
        for label, image in visuals.items():
            vol = tensor2im(_to_zyx(image), imtype=np.uint8)
            mid = vol.shape[0] // 2
            fig_slice, axes = plt.subplots(1, 3, dpi=150)
            for ax, (img, title) in zip(axes, [(vol[mid, :, :], "XY slice"),
                                               (vol[:, mid, :], "XZ slice"),
                                               (vol[:, :, mid], "YZ slice")]):
                ax.set_axis_off()
                ax.set_title(title)
                ax.imshow(img, cmap="gray")
            plt.close(fig_slice)
            fig_mip, axes = plt.subplots(1, 3, dpi=150)
            for ax, (img, title) in zip(axes, [(np.amax(vol, 0), "XY MIP"),
                                               (np.amax(vol, 1), "XZ MIP"),
                                               (np.amax(vol, 2), "YZ MIP")]):
                ax.set_axis_off()
                ax.set_title(title)
                ax.imshow(img, vmax=256, cmap="gray")
            plt.close(fig_mip)
            self.tb_writer.add_figure("train_slice_images/" + label, fig_slice, epoch)
            self.tb_writer.add_figure("train_mip_images/" + label, fig_mip, epoch)

    def display_model_hyperparameters(self):
        if self.tb_writer is None:
            return
        message = "--------------- Options ------------------  \n"
        for k, v in sorted(vars(self.opt).items()):
            message += "**{:>1}**: {:>10}  \n".format(str(k), str(v))
        message += "----------------- End -------------------"
        self.tb_writer.add_text("Model_hyperparameters", message)

    def display_current_histogram(self, visuals, epoch):
        if self.tb_writer is None or not self.display_histogram:
            return
        for label, image in visuals.items():
            self.tb_writer.add_histogram("train_histograms/" + label, _to_zyx(image), epoch)

    def save_current_visuals(self, visuals, epoch) -> list:
        """Each visual as ``{epoch}_{label}.tif`` (uint8) under web/images;
        returns the paths (none with ``--no_html``)."""
        paths = []
        if not self.use_html:
            return paths
        for label, image in visuals.items():
            path = os.path.join(self.img_dir, f"{epoch}_{label}.tif")
            tiffio.imwrite(path, tensor2im(_to_zyx(image), imtype=np.uint8))
            paths.append(path)
        return paths

    def update_html(self, visuals, total_iters) -> None:
        """The middle slice of each visual as ``iter{N}_{label}.png`` under
        web/images, then ``web/index.html`` rewritten with every iteration
        whose thumbnails are there (a resumed run's included), newest
        first."""
        if not self.use_html:
            return
        labels = list(visuals)
        for label, image in visuals.items():
            vol = tensor2im(_to_zyx(image), imtype=np.uint8)
            save_image(vol[vol.shape[0] // 2] if vol.ndim == 3 else vol,
                       os.path.join(self.img_dir, f"iter{total_iters}_{label}.png"))
        found = {int(m.group(1)) for m in (re.fullmatch(rf"iter(\d+)_{re.escape(labels[0])}\.png", f)
                                           for f in os.listdir(self.img_dir)) if m}
        page = html.HTML(self.web_dir, f"Experiment name = {self.name}", refresh=1)
        for n in sorted(found, reverse=True):
            page.add_header(f"iteration [{n}]")
            ims = [f"images/iter{n}_{label}.png" for label in labels]
            page.add_images(ims, labels, ims, width=256)
        page.save()

    def reset(self):
        """The start of an epoch (the JAX visualizer's flag; nothing to clear
        here)."""

    def plot_current_losses(self, plot_count, losses, is_epoch=False):
        if self.tb_writer is None:
            return
        tag = "train_by_epoch/" if is_epoch else "train_by_epoch_progress/"
        for label, loss in losses.items():
            self.tb_writer.add_scalar(tag + label, loss, plot_count)

    def print_current_losses(self, epoch, epoch_progress, losses, t_comp, t_data):
        message = ("(epoch: %d, epoch_progress: %d%%, iter time: %.3f, "
                   "data load time: %.3f) " % (epoch, epoch_progress, t_comp, t_data))
        for k, v in losses.items():
            message += "%s: %.3f " % (k, v)
        print(message, flush=True)
        with open(self.log_name, "a") as log_file:
            log_file.write(f"{message}\n")

    def close(self):
        if self.tb_writer is not None:
            self.tb_writer.close()


def save_images(webpage, visuals, image_path, width=256):
    """Add one row of thumbnails to ``webpage`` (an ``html.HTML``): each
    visual as ``images/<label>/<name>_<label>.png``, linked relative to the
    page.  [0, 1] float visuals are cast to uint8; integer ones (the tiled
    inference's outputs) are min-max stretched to uint8; a 3D visual shows
    its middle slice."""
    import ntpath

    image_dir = webpage.get_image_dir()
    short_path = ntpath.basename(image_path[0] if isinstance(image_path, list) else image_path)
    name = os.path.splitext(short_path)[0]
    webpage.add_header(name)
    ims, txts, links = [], [], []
    for label, im_data in visuals.items():
        arr = np.squeeze(np.asarray(im_data))
        if np.issubdtype(arr.dtype, np.integer):
            lo, hi = float(arr.min()), float(arr.max())
            image_numpy = ((arr.astype(np.float32) - lo)
                           * (255.0 / max(hi - lo, 1.0))).astype(np.uint8)
        else:
            image_numpy = np.squeeze(tensor2im(arr, imtype=np.uint8))
        label_dir = os.path.join(image_dir, label)
        os.makedirs(label_dir, exist_ok=True)
        save_path = os.path.join(label_dir, f"{name}_{label}.png")
        save_image(image_numpy if image_numpy.ndim == 2
                   else image_numpy[image_numpy.shape[0] // 2], save_path)
        rel = os.path.relpath(save_path, webpage.web_dir)
        ims.append(rel)
        txts.append(label)
        links.append(rel)
    webpage.add_images(ims, txts, links, width=width)


def save_test_metrics(save_dir, opt, ssims, psnrs):
    """Append the original's per-item metrics lines to ``metrics.txt``:
    ``ssims`` and ``psnrs`` are (input avg, output avg, input whole, output
    whole)."""
    message = "Experiment Name: " + opt.name + "\n"
    message += "-------------------------------------------------\n"
    message += "Network Input vs. Groundtruth\n"
    message += ("(ssim_avg: %.4f, psnr_avg: %.4f, ssim_whole: %.4f, psnr_whole: %.4f)\n"
                % (ssims[0], psnrs[0], ssims[2], psnrs[2]))
    message += "-------------------------------------------------\n"
    message += "Network Output vs. Groundtruth\n"
    message += ("(ssim_avg: %.4f, psnr_avg: %.4f, ssim_whole: %.4f, psnr_whole: %.4f)\n"
                % (ssims[1], psnrs[1], ssims[3], psnrs[3]))
    message += "-------------------------------------------------"
    print(message)
    with open(os.path.join(save_dir, "metrics.txt"), "a") as f:
        f.write(f"{message}\n")
