"""pmnist: MNIST idx-ubyte files -> one text sample file per image.

Rebuild of the reference's ``tutorials/mnist/prepare_mnist.c``:

* reads ``./train_labels``, ``./train_images``, ``./test_labels``,
  ``./test_images`` (the renamed MNIST idx files, ``prepare_mnist.c:33-37``)
  from the current directory;
* writes ``s%05d.txt`` files -- the index CONTINUES from the training set
  into the test set (``prepare_mnist.c:73`` shares ``index``), so tests are
  s60001... on the standard corpus;
* sample format (``write_output``, ``prepare_mnist.c:47-60``):

      [input] 784
      <784 pixels at %7.5f, raw 0-255, NOT normalized>
      [output] 10  #<label>
      <one-hot as 1.0 / -1.0>

Reference bug handled: the test-set loop reads the first label TWICE
(``prepare_mnist.c:228-231`` duplicates the "first label" read), pairing
every test image i with label i+1 and dropping the last image -- the
reference's whole test corpus is mislabeled by one.  Default behavior here
is the CORRECT pairing; pass ``--reference-quirks`` to reproduce the
reference byte-for-byte (documented deviation).
"""

from __future__ import annotations

import os
import struct
import sys


def _read_idx_labels(path: str) -> tuple[int, list[int]]:
    try:
        fp = open(path, "rb")
    except OSError:
        sys.stderr.write(f"FAILED to open label file {path} for READ!\n")
        raise SystemExit(-1)
    with fp:
        try:
            magic, size = struct.unpack(">II", fp.read(8))
        except struct.error:
            sys.stderr.write(f"READ FAIL: {path}\n")
            raise SystemExit(-1)
        data = fp.read(size)
    return magic, list(data)


def _read_idx_images(path: str) -> tuple[int, list[bytes], int]:
    try:
        fp = open(path, "rb")
    except OSError:
        sys.stderr.write(f"FAILED to open image file {path} for READ!\n")
        raise SystemExit(-1)
    with fp:
        try:
            magic, size, rows, cols = struct.unpack(">IIII", fp.read(16))
        except struct.error:
            sys.stderr.write(f"READ FAIL: {path}\n")
            raise SystemExit(-1)
        npx = rows * cols
        images = []
        for i in range(size):
            img = fp.read(npx)
            if len(img) != npx:
                # short fread: the reference's _READ_N aborts
                # (prepare_mnist.c:130-136)
                sys.stderr.write(
                    f"READ FAIL: image {i + 1} read {len(img)} of "
                    f"{npx} requested\n")
                raise SystemExit(-1)
            images.append(img)
    return magic, images, npx


def write_sample(fp, pixels, label: int, n_out: int = 10) -> None:
    """write_output (prepare_mnist.c:47-60), byte-identical."""
    fp.write(f"[input] {len(pixels)}\n")
    fp.write(" ".join(f"{float(p):7.5f}" for p in pixels))
    fp.write("\n")
    fp.write(f"[output] {n_out}  #{label}\n")  # two spaces before #
    fp.write(" ".join("1.0" if label == i else "-1.0" for i in range(n_out)))
    fp.write("\n")


def convert_set(label_path: str, image_path: str, out_dir: str,
                start_index: int, what: str,
                quirk_offbyone: bool = False) -> int:
    """Convert one (labels, images) pair; returns the next free index."""
    magic_l, labels = _read_idx_labels(label_path)
    magic_i, images, npx = _read_idx_images(image_path)
    if len(labels) != len(images):
        sys.stderr.write(
            f"ERROR: different set size!\n-- {label_path} has "
            f"{len(labels)} and {image_path} has {len(images)}")
        raise SystemExit(-1)
    sys.stdout.write(f"# Opened {what} label={magic_l:X} image={magic_i:X}\n")
    if quirk_offbyone and what == "tests":
        # the reference consumes the first test label twice
        # (prepare_mnist.c:228-231): image i pairs with label i+1 and the
        # last image is dropped
        labels = labels[1:]
        images = images[: len(labels)]
    index = start_index
    for label, img in zip(labels, images):
        index += 1
        if label > 9:
            sys.stderr.write("ERROR: label out of boundaries!\n")
            continue
        name = os.path.join(out_dir, f"s{index:05d}.txt")
        try:
            fp = open(name, "w")
        except OSError:
            sys.stderr.write(f"FAILED to open sample {name} for WRITE!\n")
            raise SystemExit(-1)
        with fp:
            write_sample(fp, img, label)
    return index


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    quirk = "--reference-quirks" in argv
    argv = [a for a in argv if a != "--reference-quirks"]
    if argv and argv[0] in ("-h", "--h", "--help"):
        sys.stdout.write(
            "usage: pmnist [--reference-quirks] samples_dir tests_dir\n"
            "reads ./train_labels ./train_images ./test_labels "
            "./test_images (renamed MNIST idx files)\n")
        return 0
    if len(argv) < 2:
        sys.stderr.write("ERROR not enough arguments!\n")
        return 1
    sample_wd, test_wd = argv[0], argv[1]
    sys.stdout.write(
        f"processing sample database into {sample_wd} directory.\n")
    sys.stdout.write(
        f"processing   test database into {test_wd} directory.\n")
    idx = convert_set("./train_labels", "./train_images", sample_wd, 0,
                      "samples", quirk)
    if not quirk:
        # loud one-liner: the default test-set pairing FIXES the
        # reference's off-by-one label bug, so files will not be
        # byte-identical to a reference-generated corpus (ADVICE r1)
        sys.stdout.write(
            "note: test-set labels use the CORRECTED pairing; pass "
            "--reference-quirks to reproduce the reference's off-by-one "
            "byte-exactly.\n")
    convert_set("./test_labels", "./test_images", test_wd, idx,
                "tests", quirk)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
