"""Assemble_Dice: overlap-tile reassembly on the host, the port of
``neuroclear_tpu/utils/assemble.py`` (numpy, the same operations in the same
order, so both packages assemble the same cubes to the same bits).

Cubes arrive in x -> y -> z dicing order as (1, z, y, x, 1) float32 arrays;
the border_cut margins are trimmed, the overlapping regions are averaged by a
coverage mask (sums in float32 in dicing order, then a division by
max(mask, 1)), then the optional percentile stretch and the integer cast, and
the dicing pad is cropped off.  Two departures of the JAX package from the
original repository are kept: it always accumulates (the original left the
volume zero when overlap was 0), and it crops with ``[:original_extent]``
(the original's ``[:-pad]`` broke where a pad was 0).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from .imageops import match_histograms, rescale_intensity

# the spatial axes of a (B, z, y, x, C) visual
TTA_AXES = (1, 2, 3)


class Assemble_Dice:
    def __init__(self, opt, dataset=None):
        if dataset is None:
            from .. import data as data_registry

            dataset = data_registry.find_dataset_using_name(opt.dataset_mode)(opt)
        self.image_size_original = dataset.size_original()
        self.image_size = dataset.size()
        self.border_cut = opt.border_cut

        self.roi_size = opt.dice_size[0]
        self.overlap = opt.overlap
        self.step = self.roi_size - self.overlap

        self.z_steps = (self.image_size[0] - self.overlap) // self.step
        self.y_steps = (self.image_size[1] - self.overlap) // self.step
        self.x_steps = (self.image_size[2] - self.overlap) // self.step

        self.visual_ret = OrderedDict()
        self.visual_names = ["real", "fake"]
        self.snapDict = OrderedDict()
        self.cube_queue = OrderedDict()
        self.mask_ret = OrderedDict()
        self.imtype = opt.data_type
        self.skip_real = opt.skip_real
        self.histogram_match = opt.histogram_match
        self.normalize_intensity = opt.normalize_intensity
        if self.normalize_intensity:
            self.p1, self.p99 = opt.sat_level
        if self.histogram_match:
            print("We will match the histograms of output sub-volumes with input sub-volumes.")
        if self.skip_real:
            print("We will skip assembling for the real (input) volume. ")

        self.len_cube_queue = self.z_steps * self.x_steps * self.y_steps
        for name in self.visual_names:
            if self.skip_real and name == "real":
                continue
            self.visual_ret[name] = np.zeros(self.image_size, dtype=np.float32)
            self.mask_ret[name] = np.zeros(self.image_size, dtype=np.float32)
            self.cube_queue[name] = []

    # ------------------------------------------------------------- indexing

    def indexTo3DIndex(self, index):
        x = index % self.x_steps
        y = (index % (self.x_steps * self.y_steps)) // self.x_steps
        z = index // (self.x_steps * self.y_steps)
        return z, y, x

    def indexToCoordinates(self, index):
        z, y, x = self.indexTo3DIndex(index)
        return z * self.step, y * self.step, x * self.step

    def if_overEdge(self, index):
        z, y, x = self.indexTo3DIndex(index)
        return (z > self.z_steps or z < 0 or y > self.y_steps or y < 0
                or x > self.x_steps or x < 0 or index > self.len_cube_queue - 1)

    # ------------------------------------------------------ TTA (repetition)

    def varycubeinput(self, input):
        """Flip-augment one input dict into [original, flip(z), flip(y),
        flip(x)] copies."""
        keys = list(input.keys())
        vis, path = input[keys[0]], input[keys[1]]
        vis = np.asarray(vis)
        out = [input]
        for axis in TTA_AXES:
            d = OrderedDict()
            d[keys[0]] = np.flip(vis, axis)
            d[keys[1]] = path
            out.append(d)
        return out

    def combinecube(self, visual_list):
        """Unflip the augmented outputs and average them."""
        keys = list(visual_list[0].keys())
        unflipped = [visual_list[0]]
        for i, flipped in enumerate(visual_list[1:]):
            d = OrderedDict()
            for name in keys:
                d[name] = np.flip(np.asarray(flipped[name]), TTA_AXES[i])
            unflipped.append(d)
        out = OrderedDict()
        for name in keys:
            out[name] = np.mean(np.stack([np.asarray(u[name]) for u in unflipped], 0), 0)
        return out

    # -------------------------------------------------------------- pipeline

    def addToStack(self, cube):
        """``cube``: {"real", "fake"} host arrays of one cube."""
        cube_dict = OrderedDict()
        for name in self.visual_names:
            arr = np.asarray(cube[name], dtype=np.float32)
            arr = np.squeeze(arr)  # the batch and channel dims
            b = self.border_cut
            if b > 0:
                arr = arr[b:-b, b:-b, b:-b]
            if arr.shape != (self.roi_size,) * 3:
                raise ValueError(f"the cube dimensions are invalid: {arr.shape}")
            cube_dict[name] = arr

        if self.histogram_match:
            cube_dict["fake"] = match_histograms(cube_dict["fake"], cube_dict["real"])

        for name in self.visual_names:
            if self.skip_real and name == "real":
                continue
            self.cube_queue[name].append(cube_dict[name])

    def assemble_all(self):
        for name in self.visual_names:
            if self.skip_real and name == "real":
                continue
            print("Patching for... " + str(name))
            r = self.roi_size
            for index, cube in enumerate(self.cube_queue[name]):
                if cube.shape != (r, r, r):
                    raise ValueError("The cube does not have the proper size.")
                z, y, x = self.indexToCoordinates(index)
                self.visual_ret[name][z:z + r, y:y + r, x:x + r] += cube
                self.mask_ret[name][z:z + r, y:y + r, x:x + r] += 1.0
            print(f"done patching the cubes for {name} image volume.")

            self.visual_ret[name] = self.visual_ret[name] / np.maximum(self.mask_ret[name], 1.0)
            print(f"All gaps merged for {name} image volume.")
            print("For debug: maximum iterations of overlaps: "
                  + str(np.max(self.mask_ret[name])))

            if self.normalize_intensity:
                p1_, p99_ = np.percentile(self.visual_ret[name], (self.p1, self.p99))
                self.visual_ret[name] = rescale_intensity(self.visual_ret[name],
                                                          in_range=(p1_, p99_))

            if self.imtype == "uint8":
                self.visual_ret[name] = (self.visual_ret[name] * 255).astype(np.uint8)
            elif self.imtype == "uint16":
                self.visual_ret[name] = (self.visual_ret[name] * (2 ** 16 - 1)).astype(np.uint16)

            if self.image_size_original is not None:
                oz, oy, ox = self.image_size_original
                self.visual_ret[name] = self.visual_ret[name][:oz, :oy, :ox]

    # -------------------------------------------------------------- getters

    def getSnapshots(self, index, slice_axis=2):
        for name in self.visual_names:
            if self.skip_real and name == "real":
                continue
            if slice_axis == 0:
                self.snapDict[name] = self.visual_ret[name][index, :, :]
            elif slice_axis == 1:
                self.snapDict[name] = self.visual_ret[name][:, index, :]
            else:
                self.snapDict[name] = self.visual_ret[name][:, :, index]
        return self.snapDict

    def getDict(self):
        return self.visual_ret

    def getMaskRet(self):
        return self.mask_ret["real"]

    def getCubeQueue(self):
        return self.cube_queue
