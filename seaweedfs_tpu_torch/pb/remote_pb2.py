# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: remote.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0cremote.proto\x12\x11weedtpu_remote_pb\"\x90\x01\n\nRemoteConf\x12\x0c\n\x04type\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x0c\n\x04root\x18\x03 \x01(\t\x12\x10\n\x08\x65ndpoint\x18\x04 \x01(\t\x12\x12\n\naccess_key\x18\x05 \x01(\t\x12\x12\n\nsecret_key\x18\x06 \x01(\t\x12\x0e\n\x06\x62ucket\x18\x07 \x01(\t\x12\x0e\n\x06region\x18\x08 \x01(\t\"@\n\x0eRemoteConfList\x12.\n\x07remotes\x18\x01 \x03(\x0b\x32\x1d.weedtpu_remote_pb.RemoteConf\":\n\x15RemoteStorageLocation\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x13\n\x0bremote_path\x18\x02 \x01(\t\"\xba\x01\n\x14RemoteStorageMapping\x12G\n\x08mappings\x18\x01 \x03(\x0b\x32\x35.weedtpu_remote_pb.RemoteStorageMapping.MappingsEntry\x1aY\n\rMappingsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\x37\n\x05value\x18\x02 \x01(\x0b\x32(.weedtpu_remote_pb.RemoteStorageLocation:\x02\x38\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'remote_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _REMOTESTORAGEMAPPING_MAPPINGSENTRY._options = None
  _REMOTESTORAGEMAPPING_MAPPINGSENTRY._serialized_options = b'8\001'
  _REMOTECONF._serialized_start=36
  _REMOTECONF._serialized_end=180
  _REMOTECONFLIST._serialized_start=182
  _REMOTECONFLIST._serialized_end=246
  _REMOTESTORAGELOCATION._serialized_start=248
  _REMOTESTORAGELOCATION._serialized_end=306
  _REMOTESTORAGEMAPPING._serialized_start=309
  _REMOTESTORAGEMAPPING._serialized_end=495
  _REMOTESTORAGEMAPPING_MAPPINGSENTRY._serialized_start=406
  _REMOTESTORAGEMAPPING_MAPPINGSENTRY._serialized_end=495
# @@protoc_insertion_point(module_scope)
