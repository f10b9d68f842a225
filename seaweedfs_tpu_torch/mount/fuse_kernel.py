"""Raw FUSE kernel protocol implementation (no libfuse).

The reference's `weed mount` uses hanwen/go-fuse, which speaks the kernel
FUSE wire protocol directly rather than linking libfuse
(reference weed/mount/weedfs.go); we do the same: open /dev/fuse, mount(2)
with fd=N options, then serve fuse_in_header-framed requests. Struct
layouts follow /usr/include/linux/fuse.h (protocol 7.x); we negotiate
minor 31 semantics.

`FuseConnection` owns the device fd and the serve loop; filesystem
behavior is delegated to an Operations object (see weedfs.py).

The port's copy of seaweedfs_tpu/mount/fuse_kernel.py. It imports nothing
of that package.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import errno
import os
import stat as statmod
import struct
import threading
from typing import Optional

# opcodes (linux/fuse.h:517-560)
FUSE_LOOKUP = 1
FUSE_FORGET = 2
FUSE_GETATTR = 3
FUSE_SETATTR = 4
FUSE_READLINK = 5
FUSE_SYMLINK = 6
FUSE_MKNOD = 8
FUSE_MKDIR = 9
FUSE_LINK = 13
FUSE_UNLINK = 10
FUSE_RMDIR = 11
FUSE_RENAME = 12
FUSE_OPEN = 14
FUSE_READ = 15
FUSE_WRITE = 16
FUSE_STATFS = 17
FUSE_RELEASE = 18
FUSE_FSYNC = 20
FUSE_SETXATTR = 21
FUSE_GETXATTR = 22
FUSE_LISTXATTR = 23
FUSE_REMOVEXATTR = 24
FUSE_FLUSH = 25
FUSE_INIT = 26
FUSE_OPENDIR = 27
FUSE_READDIR = 28
FUSE_RELEASEDIR = 29
FUSE_ACCESS = 34
FUSE_CREATE = 35
FUSE_INTERRUPT = 36
FUSE_DESTROY = 38
FUSE_BATCH_FORGET = 42
FUSE_READDIRPLUS = 44
FUSE_RENAME2 = 45

IN_HEADER = struct.Struct("<IIQQIIIHH")  # len opcode unique nodeid uid gid pid extlen pad
OUT_HEADER = struct.Struct("<IiQ")  # len error unique
ATTR = struct.Struct("<QQQQQQIIIIIIIIII")  # fuse_attr
ENTRY_OUT_HEAD = struct.Struct("<QQQQII")  # nodeid gen entry_valid attr_valid nsecs
ATTR_OUT_HEAD = struct.Struct("<QII")  # attr_valid, attr_valid_nsec, dummy
INIT_IN = struct.Struct("<IIII")  # major minor max_readahead flags (+flags2+unused)
INIT_OUT = struct.Struct("<IIIIHHIIHHI28x")  # through flags2 + unused[7]
OPEN_OUT = struct.Struct("<QII")
WRITE_OUT = struct.Struct("<II")
GETATTR_IN = struct.Struct("<IIQ")
SETATTR_IN = struct.Struct("<IIQQQQQQIIIIIIII")
READ_IN = struct.Struct("<QQIIQII")
WRITE_IN = struct.Struct("<QQIIQII")
RELEASE_IN = struct.Struct("<QIIQ")
CREATE_IN = struct.Struct("<IIII")
MKDIR_IN = struct.Struct("<II")
RENAME_IN = struct.Struct("<Q")
RENAME2_IN = struct.Struct("<QII")
KSTATFS = struct.Struct("<QQQQQIIII24x")

ROOT_ID = 1


class FileAttr:
    __slots__ = ("ino", "size", "mtime", "mode", "nlink", "uid", "gid")

    def __init__(self, ino=0, size=0, mtime=0.0, mode=0o644, is_dir=False,
                 nlink=1, uid=0, gid=0):
        self.ino = ino
        self.size = size
        self.mtime = mtime
        self.mode = mode | (statmod.S_IFDIR if is_dir else statmod.S_IFREG) \
            if not (mode & 0o170000) else mode
        self.nlink = nlink
        self.uid = uid
        self.gid = gid

    def pack(self) -> bytes:
        sec = int(self.mtime)
        nsec = int((self.mtime - sec) * 1e9)
        return ATTR.pack(
            self.ino, self.size, (self.size + 511) // 512,
            sec, sec, sec, nsec, nsec, nsec,
            self.mode, self.nlink, self.uid, self.gid, 0, 4096, 0)


class FuseError(OSError):
    pass


def _libc():
    return ctypes.CDLL(None, use_errno=True)


def mount_fuse(mountpoint: str, fsname: str = "seaweedfs-tpu") -> int:
    """open /dev/fuse + mount(2). Returns the device fd."""
    fd = os.open("/dev/fuse", os.O_RDWR)
    st = os.stat(mountpoint)
    opts = (f"fd={fd},rootmode={st.st_mode & 0o170000:o},"
            f"user_id=0,group_id=0,allow_other")
    libc = _libc()
    ret = libc.mount(fsname.encode(), mountpoint.encode(), b"fuse",
                     0, opts.encode())
    if ret != 0:
        e = ctypes.get_errno()
        os.close(fd)
        raise FuseError(e, f"mount failed: {os.strerror(e)}")
    return fd


def umount(mountpoint: str) -> None:
    libc = _libc()
    if libc.umount2(mountpoint.encode(), 2) != 0:  # MNT_DETACH
        libc.umount(mountpoint.encode())


class FuseConnection:
    """Serve loop: parse requests, dispatch to ops, write replies."""

    MAX_WRITE = 1 << 20

    def __init__(self, ops, mountpoint: str):
        self.ops = ops
        self.mountpoint = mountpoint
        self.fd = mount_fuse(mountpoint)
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self.proto_minor = 31

    # ---- replies ----
    def _reply(self, unique: int, payload: bytes = b"", error: int = 0):
        buf = OUT_HEADER.pack(OUT_HEADER.size + len(payload), -error,
                              unique) + payload
        try:
            os.write(self.fd, buf)
        except OSError:
            pass

    def _reply_err(self, unique: int, err: int):
        self._reply(unique, b"", err)

    def _reply_entry(self, unique: int, attr: FileAttr):
        payload = ENTRY_OUT_HEAD.pack(attr.ino, 0, 1, 1, 0, 0) + attr.pack()
        self._reply(unique, payload)

    def _reply_attr(self, unique: int, attr: FileAttr):
        self._reply(unique, ATTR_OUT_HEAD.pack(1, 0, 0) + attr.pack())

    # ---- loop ----
    def serve_forever(self, background: bool = True):
        if background:
            self._thread = threading.Thread(target=self._loop, daemon=True,
                                            name="fuse-loop")
            self._thread.start()
        else:
            self._loop()

    def _loop(self):
        bufsize = self.MAX_WRITE + 4096
        while not self._stop:
            try:
                req = os.read(self.fd, bufsize)
            except OSError as e:
                if e.errno in (errno.ENODEV, errno.EBADF):
                    return  # unmounted
                if e.errno == errno.EINTR:
                    continue
                return
            if not req:
                return
            try:
                self._dispatch(req)
            except Exception:
                try:
                    (_, _, unique, *_rest) = IN_HEADER.unpack_from(req)
                    self._reply_err(unique, errno.EIO)
                except Exception:
                    pass

    def close(self):
        self._stop = True
        umount(self.mountpoint)
        try:
            os.close(self.fd)
        except OSError:
            pass

    # ---- dispatch ----
    def _dispatch(self, req: bytes):
        (length, opcode, unique, nodeid, uid, gid, pid, _extlen,
         _pad) = IN_HEADER.unpack_from(req)
        body = req[IN_HEADER.size:length]
        if opcode == FUSE_INIT:
            major, minor, max_ra, flags = INIT_IN.unpack_from(body)
            self.proto_minor = min(minor, 31)
            out = INIT_OUT.pack(7, self.proto_minor, max_ra, 0, 12, 10,
                                self.MAX_WRITE, 1, 256, 0, 0)
            self._reply(unique, out)
            return
        if opcode in (FUSE_FORGET, FUSE_BATCH_FORGET):
            return  # no reply
        if opcode == FUSE_DESTROY:
            self._reply(unique)
            return
        if opcode == FUSE_INTERRUPT:
            self._reply_err(unique, errno.EAGAIN)
            return
        handler = {
            FUSE_LOOKUP: self._op_lookup,
            FUSE_GETATTR: self._op_getattr,
            FUSE_SETATTR: self._op_setattr,
            FUSE_MKDIR: self._op_mkdir,
            FUSE_UNLINK: self._op_unlink,
            FUSE_RMDIR: self._op_rmdir,
            FUSE_RENAME: self._op_rename,
            FUSE_RENAME2: self._op_rename2,
            FUSE_OPEN: self._op_open,
            FUSE_READ: self._op_read,
            FUSE_WRITE: self._op_write,
            FUSE_STATFS: self._op_statfs,
            FUSE_RELEASE: self._op_release,
            FUSE_FLUSH: self._op_flush,
            FUSE_FSYNC: self._op_flush,
            FUSE_OPENDIR: self._op_opendir,
            FUSE_READDIR: self._op_readdir,
            FUSE_RELEASEDIR: lambda u, n, b: self._reply(u),
            FUSE_ACCESS: lambda u, n, b: self._reply(u),
            FUSE_CREATE: self._op_create,
            FUSE_SYMLINK: self._op_symlink,
            FUSE_READLINK: self._op_readlink,
            FUSE_LINK: self._op_link,
            FUSE_GETXATTR: self._op_getxattr,
            FUSE_LISTXATTR: self._op_listxattr,
            FUSE_SETXATTR: self._op_setxattr,
            FUSE_REMOVEXATTR: self._op_removexattr,
        }.get(opcode)
        if handler is None:
            self._reply_err(unique, errno.ENOSYS)
            return
        handler(unique, nodeid, body)

    # ---- xattr ops (reference weedfs_xattr.go: attributes live in
    # Entry.Extended; get/list answer the size-probe convention) ----
    def _op_setxattr(self, unique, nodeid, body):
        # fuse_setxattr_in: size u32, flags u32; then name\0value
        size, flags = struct.unpack_from("<II", body)
        rest = body[8:]
        name, _, tail = rest.partition(b"\x00")
        value = tail[:size]
        err = self.ops.setxattr(nodeid, name.decode(), value, flags)
        if err:
            self._reply_err(unique, err)
        else:
            self._reply(unique)

    def _op_getxattr(self, unique, nodeid, body):
        out_size, _pad = struct.unpack_from("<II", body)
        name = body[8:].rstrip(b"\x00").decode()
        value = self.ops.getxattr(nodeid, name)
        if value is None:
            self._reply_err(unique, errno.ENODATA)
            return
        if out_size == 0:  # size probe: fuse_getxattr_out
            self._reply(unique, struct.pack("<II", len(value), 0))
        elif len(value) > out_size:
            self._reply_err(unique, errno.ERANGE)
        else:
            self._reply(unique, value)

    def _op_listxattr(self, unique, nodeid, body):
        out_size, _pad = struct.unpack_from("<II", body)
        names = self.ops.listxattr(nodeid)
        payload = b"".join(n.encode() + b"\x00" for n in names)
        if out_size == 0:
            self._reply(unique, struct.pack("<II", len(payload), 0))
        elif len(payload) > out_size:
            self._reply_err(unique, errno.ERANGE)
        else:
            self._reply(unique, payload)

    def _op_removexattr(self, unique, nodeid, body):
        name = body.rstrip(b"\x00").decode()
        err = self.ops.removexattr(nodeid, name)
        if err:
            self._reply_err(unique, err)
        else:
            self._reply(unique)

    # ---- ops ----
    def _op_lookup(self, unique, nodeid, body):
        name = body.rstrip(b"\x00").decode()
        attr = self.ops.lookup(nodeid, name)
        if attr is None:
            self._reply_err(unique, errno.ENOENT)
        else:
            self._reply_entry(unique, attr)

    def _op_getattr(self, unique, nodeid, body):
        attr = self.ops.getattr(nodeid)
        if attr is None:
            self._reply_err(unique, errno.ENOENT)
        else:
            self._reply_attr(unique, attr)

    def _op_setattr(self, unique, nodeid, body):
        (valid, _pad, fh, size, _lo, atime, mtime, _ct, _ans, _mns, _cns,
         mode, _u4, uid, gid, _u5) = SETATTR_IN.unpack_from(body)
        attr = self.ops.setattr(nodeid, valid, size=size, mode=mode,
                                mtime=mtime, fh=fh)
        if attr is None:
            self._reply_err(unique, errno.ENOENT)
        else:
            self._reply_attr(unique, attr)

    def _op_mkdir(self, unique, nodeid, body):
        mode, _umask = MKDIR_IN.unpack_from(body)
        name = body[MKDIR_IN.size:].rstrip(b"\x00").decode()
        attr = self.ops.mkdir(nodeid, name, mode)
        self._reply_entry(unique, attr)

    def _op_unlink(self, unique, nodeid, body):
        name = body.rstrip(b"\x00").decode()
        err = self.ops.unlink(nodeid, name)
        self._reply_err(unique, err) if err else self._reply(unique)

    def _op_rmdir(self, unique, nodeid, body):
        name = body.rstrip(b"\x00").decode()
        err = self.ops.rmdir(nodeid, name)
        self._reply_err(unique, err) if err else self._reply(unique)

    def _op_rename(self, unique, nodeid, body):
        newdir, = RENAME_IN.unpack_from(body)
        self._do_rename(unique, nodeid, newdir, body[RENAME_IN.size:])

    def _op_rename2(self, unique, nodeid, body):
        newdir, _flags, _pad = RENAME2_IN.unpack_from(body)
        self._do_rename(unique, nodeid, newdir, body[RENAME2_IN.size:])

    def _do_rename(self, unique, nodeid, newdir, rest):
        names = rest.split(b"\x00")
        oldname, newname = names[0].decode(), names[1].decode()
        err = self.ops.rename(nodeid, oldname, newdir, newname)
        self._reply_err(unique, err) if err else self._reply(unique)

    def _op_open(self, unique, nodeid, body):
        fh = self.ops.open(nodeid)
        if fh is None:
            self._reply_err(unique, errno.ENOENT)
        else:
            self._reply(unique, OPEN_OUT.pack(fh, 0, 0))

    def _op_opendir(self, unique, nodeid, body):
        self._reply(unique, OPEN_OUT.pack(0, 0, 0))

    def _op_read(self, unique, nodeid, body):
        fh, offset, size, _rf, _lo, _fl, _pad = READ_IN.unpack_from(body)
        data = self.ops.read(nodeid, fh, offset, size)
        if data is None:
            self._reply_err(unique, errno.EBADF)
        else:
            self._reply(unique, data)

    def _op_write(self, unique, nodeid, body):
        fh, offset, size, _wf, _lo, _fl, _pad = WRITE_IN.unpack_from(body)
        data = body[WRITE_IN.size:WRITE_IN.size + size]
        written = self.ops.write(nodeid, fh, offset, data)
        if written is None:
            self._reply_err(unique, errno.EBADF)
        else:
            self._reply(unique, WRITE_OUT.pack(written, 0))

    def _op_symlink(self, unique, nodeid, body):
        # body: linkname\0 target\0 (fuse SYMLINK sends name first)
        name, _, rest = body.partition(b"\x00")
        target = rest.split(b"\x00", 1)[0]
        attr = self.ops.symlink(nodeid, name.decode(), target.decode())
        if attr is None:
            self._reply_err(unique, errno.EEXIST)
        else:
            self._reply_entry(unique, attr)

    def _op_readlink(self, unique, nodeid, body):
        target = self.ops.readlink(nodeid)
        if target is None:
            self._reply_err(unique, errno.EINVAL)
        else:
            self._reply(unique, target.encode())

    def _op_link(self, unique, nodeid, body):
        old_nodeid, = struct.unpack_from("<Q", body)
        name = body[8:].rstrip(b"\x00").decode()
        try:
            attr = self.ops.link(old_nodeid, nodeid, name)
        except FileExistsError:
            self._reply_err(unique, errno.EEXIST)
            return
        if attr is None:
            self._reply_err(unique, errno.ENOENT)
        else:
            self._reply_entry(unique, attr)

    def _op_statfs(self, unique, nodeid, body):
        stats = None
        statfs = getattr(self.ops, "statfs", None)
        if statfs is not None:
            stats = statfs()
        if stats is None:  # static fallback
            stats = (1 << 30, 1 << 29, 1 << 29, 1 << 20, 1 << 19)
        blocks, bfree, bavail, files, ffree = stats
        self._reply(unique, KSTATFS.pack(
            blocks, bfree, bavail, files, ffree, 4096, 255, 4096, 0))

    def _op_release(self, unique, nodeid, body):
        fh, _fl, _rf, _lo = RELEASE_IN.unpack_from(body)
        self.ops.release(nodeid, fh)
        self._reply(unique)

    def _op_flush(self, unique, nodeid, body):
        fh = struct.unpack_from("<Q", body)[0]
        self.ops.flush(nodeid, fh)
        self._reply(unique)

    def _op_readdir(self, unique, nodeid, body):
        fh, offset, size, _rf, _lo, _fl, _pad = READ_IN.unpack_from(body)
        entries = self.ops.readdir(nodeid)  # list[(name, FileAttr)]
        buf = bytearray()
        idx = 0
        for name, attr in entries:
            idx += 1
            if idx <= offset:
                continue
            nb = name.encode()
            ent_len = 24 + len(nb)
            aligned = (ent_len + 7) & ~7
            if len(buf) + aligned > size:
                break
            dtype = 4 if statmod.S_ISDIR(attr.mode) else 8
            buf += struct.pack("<QQII", attr.ino, idx, len(nb), dtype)
            buf += nb + b"\x00" * (aligned - ent_len)
        self._reply(unique, bytes(buf))

    def _op_create(self, unique, nodeid, body):
        flags, mode, _umask, _of = CREATE_IN.unpack_from(body)
        name = body[CREATE_IN.size:].rstrip(b"\x00").decode()
        attr, fh = self.ops.create(nodeid, name, mode)
        payload = (ENTRY_OUT_HEAD.pack(attr.ino, 0, 1, 1, 0, 0)
                   + attr.pack() + OPEN_OUT.pack(fh, 0, 0))
        self._reply(unique, payload)
