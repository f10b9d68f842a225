# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: mount.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0bmount.proto\x12\x10weedtpu_mount_pb\"/\n\x10\x43onfigureRequest\x12\x1b\n\x13\x63ollection_capacity\x18\x01 \x01(\x03\"0\n\x11\x43onfigureResponse\x12\x1b\n\x13\x63ollection_capacity\x18\x01 \x01(\x03\x32i\n\x0fSeaweedTpuMount\x12V\n\tConfigure\x12\".weedtpu_mount_pb.ConfigureRequest\x1a#.weedtpu_mount_pb.ConfigureResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'mount_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _CONFIGUREREQUEST._serialized_start=33
  _CONFIGUREREQUEST._serialized_end=80
  _CONFIGURERESPONSE._serialized_start=82
  _CONFIGURERESPONSE._serialized_end=130
  _SEAWEEDTPUMOUNT._serialized_start=132
  _SEAWEEDTPUMOUNT._serialized_end=237
# @@protoc_insertion_point(module_scope)
